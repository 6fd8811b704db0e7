"""Model tier, optimizer, train step and environment setup."""
