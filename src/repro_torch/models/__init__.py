"""Dense transformer layers, the ALBERT-style embedder and the dense LM."""
