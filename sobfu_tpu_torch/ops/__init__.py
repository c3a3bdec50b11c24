"""Device ops of the PyTorch port: preprocessing and the CUDA kernels."""
