"""Device ops of the port: normalization, transfer encodings, resampling, kernels."""
