"""Search operators: sliding dot, exact top-k, the two pass-1 kernels, pass
2's rescore and the Hedged-MC smile's kernel."""
