"""Search operators: sliding dot, exact top-k, the two pass-1 kernels, pass
2's rescore, finalize's gathers and the Hedged-MC smile's kernel."""
