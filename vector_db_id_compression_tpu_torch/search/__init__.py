"""Search: k-means coarse quantizer, IVF with deferred ID decoding, NSG
construction and best-first graph search."""

import torch

# Distances and assignments are held against the JAX package's float32
# results, so float32 matrix products on the card must run in full float32,
# never TF32 (this is PyTorch's default; it is set here so that no caller's
# setting changes the search).
torch.backends.cuda.matmul.allow_tf32 = False
