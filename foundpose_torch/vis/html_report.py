"""HTML report assembly with base64-embedded images (a copy of
foundpose_tpu/vis/html_report.py; PIL is imported where a PNG is encoded).

Re-design of the reference HTML helpers (reference: utils/html_util.py:10-84
and the best/worst-N galleries at utils/eval_util.py:518-590).
"""

from __future__ import annotations

import base64
import io
from typing import Dict, List, Sequence, Tuple

import numpy as np


def image_to_base64_png(image: np.ndarray) -> str:
    from PIL import Image

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (255.0 * np.clip(img, 0, 1)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def image_tag(image: np.ndarray, title: str = "") -> str:
    """<img> blob for an ndarray. (reference: utils/html_util.py:10-40)"""
    b64 = image_to_base64_png(image)
    t = f"<div class='cap'>{title}</div>" if title else ""
    return (
        f"<div class='tile'>{t}<img src='data:image/png;base64,{b64}'/></div>"
    )


def assemble_page(
    sections: Sequence[Tuple[str, List[str]]], title: str = "foundpose report"
) -> str:
    """Assembles (heading, [html blobs]) sections into one page.

    (reference: utils/html_util.py:43-84)
    """
    body = []
    for heading, blobs in sections:
        body.append(f"<h2>{heading}</h2><div class='row'>{''.join(blobs)}</div>")
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ font-family: sans-serif; background: #fafafa; }}
.row {{ display: flex; flex-wrap: wrap; gap: 8px; }}
.tile {{ border: 1px solid #ddd; padding: 4px; background: #fff; }}
.cap {{ font-size: 12px; color: #444; margin-bottom: 2px; }}
img {{ max-width: 640px; }}
</style></head><body><h1>{title}</h1>{"".join(body)}</body></html>"""


def write_gallery(
    path: str,
    records: List[Dict],
    images: List[np.ndarray],
    metric_key: str = "mssd",
    top_n: int = 10,
) -> None:
    """Best/worst-N gallery by a metric. (reference: eval_util.py:518-590)"""
    scored = [
        (r, img) for r, img in zip(records, images) if r.get(metric_key) is not None
    ]
    scored.sort(key=lambda x: x[0][metric_key])
    best = [
        image_tag(img, f"{metric_key}={r[metric_key]:.2f}")
        for r, img in scored[:top_n]
    ]
    worst = [
        image_tag(img, f"{metric_key}={r[metric_key]:.2f}")
        for r, img in scored[-top_n:][::-1]
    ]
    page = assemble_page(
        [(f"Best {top_n} by {metric_key}", best), (f"Worst {top_n} by {metric_key}", worst)]
    )
    with open(path, "w") as f:
        f.write(page)
