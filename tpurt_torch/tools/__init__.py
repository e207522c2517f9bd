"""Diagnostic probes of the port, run on the card (README)."""
