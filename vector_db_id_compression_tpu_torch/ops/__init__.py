"""Hand-written CUDA kernels for the ROC codec, the IVF search's grouped
float scan and two probes of the ROC decode step, their build and their
wrappers."""
