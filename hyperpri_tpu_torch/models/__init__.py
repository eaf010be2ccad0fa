"""Model definitions (eval forms)."""
