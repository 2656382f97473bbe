"""The benchmark of the PyTorch and CUDA port (`foundpose_torch`); see README.md."""
