"""Black-Scholes inversion and Hedged Monte Carlo smiles."""
