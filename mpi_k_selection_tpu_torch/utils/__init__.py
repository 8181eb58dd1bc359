"""Seeded data, dtype transforms, interop, timing and checks."""
