"""Host-side utilities: the synthetic photographic test corpus."""
