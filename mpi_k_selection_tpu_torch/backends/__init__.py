"""Execution backends."""
