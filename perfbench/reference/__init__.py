"""The benchmark's plain reference of the online coarse-pose step.

Plain PyTorch in float32 with TF32 off (`precision.Precision(lowp=False)`),
written from the published method and not from the program: the
backbone to a facet (one module a family, `<family>.py`: DINOv2 in
`dinov2.py`), the query grid, PCA, bag-of-words tf-idf retrieval, exact
cyclic buddies, a DLT pose, and the crop cameras and the image warp of serving.
`Precision(lowp=True)` runs the same code one precision below the
configuration's in every stage (the features in fp8, the warp's
coordinates and the DLT in bfloat16): the control that has to come out as
not correct; `Precision(lowp=("features",))` lowers one stage alone.
Nothing here imports the program, JAX or the JAX package.
"""
