"""Input splitting and output writing (host-side, framework-free)."""
