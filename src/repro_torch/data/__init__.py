"""Seeded synthetic datasets (SIFT/GIST-like clustered vectors)."""
