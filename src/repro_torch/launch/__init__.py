"""Launchers of the port: ``serve`` (LM prefill + decode)."""
