"""Search operators: sliding dot, exact top-k, and the two pass-1 kernels."""
