"""Hand-written CUDA kernels for the ROC codec, their build and their
wrappers."""
