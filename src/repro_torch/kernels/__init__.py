"""Worker-step and server kernels: Hopper CUDA kernels + plain versions."""
