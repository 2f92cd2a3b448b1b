"""The benchmark of the PyTorch/CUDA port `elasticfusion_tpu_torch`."""
