"""Hand-written CUDA kernels for the ROC codec and two probes of its decode
step, their build and their wrappers."""
