"""Nothing the harness runs loads JAX, Flax or the JAX package; the
reference loads nothing of the program either, nor does any backbone
family's reference the lookup can find. Top-level module names are
compared whole: `foundpose_torch` begins with the JAX package's letters."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "foundpose_tpu"}
BLOCKED = sorted(FORBIDDEN | {"foundpose_torch"})
# Every family the lookup can find: a module under models/ with its reference.
FAMILIES = sorted(f[:-3] for f in os.listdir(os.path.join(harness.HERE, "models"))
                  if f.endswith(".py") and f != "__init__.py"
                  and os.path.exists(os.path.join(harness.HERE, "reference", f)))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    root = os.path.join(harness.HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py") and "tests" not in d.split(os.sep):
                yield os.path.join(d, f)


def test_harness_sources_import_no_jax():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _sources()}
    assert not {p: v for p, v in bad.items() if v}


def test_reference_sources_import_nothing_of_the_program():
    for p in _sources("reference"):
        tops = set(_imports(p))
        assert not tops & (FORBIDDEN | {"foundpose_torch"}), p


CHECK = """
import sys
sys.path.insert(0, {root!r})
{pre}
from perfbench.tests import tiny
tiny.run({cell!r}, 0.3)
tops = {{n.split('.')[0] for n in sys.modules}}
print(sorted(tops & {names!r}))
"""


def _loaded(cell, names, pre=""):
    code = CHECK.format(root=harness.ROOT, pre=pre, cell=cell, names=names)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    assert _loaded("vits14reg_serve_16box", FORBIDDEN) == "[]"


BLOCK = f"""
import sys
sys.path.insert(0, {harness.ROOT!r})
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {BLOCKED!r}:
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
"""


def _blocked(code):
    out = subprocess.run([sys.executable, "-c", BLOCK + code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_runs_with_the_program_unimportable():
    code = """
import torch
from perfbench import models
from perfbench.reference import camera, pipeline, pose, precision, retrieval
fam, ref = models.family('dinov2'), models.reference('dinov2')
s = fam.shape({'extractor_name': 'dinov2_version=vits14-reg_stride=14_facet=token_layer=1_norm=1',
               'vit_overrides': dict(embed_dim=128, num_heads=2, depth=3, pos_grid=6)})
w = fam.make_weights(s, 3, 'cpu')
f = ref.feature_maps(w, s, torch.rand(2, 84, 84, 3), precision.Precision())
print(tuple(f.shape))
"""
    assert _blocked(code).endswith("(2, 6, 6, 128)")


def test_every_family_is_found():
    assert "dinov2" in FAMILIES


@pytest.mark.parametrize("family", FAMILIES)
def test_family_reference_loads_nothing_of_the_program(family):
    """The family's reference, found by the lookup, with the program, JAX
    and the JAX package unimportable, and nothing of them loaded after."""
    code = f"""
from perfbench import models
models.reference({family!r})
print(sorted({{n.split('.')[0] for n in sys.modules}} & set({BLOCKED!r})))
"""
    assert _blocked(code) == "[]"
