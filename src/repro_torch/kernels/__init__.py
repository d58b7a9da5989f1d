"""Hand-written Hopper kernels (CUDA C++ under csrc/) with their plain
PyTorch versions; `ops` dispatches on the tensor's device."""
