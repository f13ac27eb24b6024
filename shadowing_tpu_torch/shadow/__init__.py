"""Embeddings, contexts, distances and the shadowing engine."""
