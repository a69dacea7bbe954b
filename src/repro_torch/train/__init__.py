"""Streamed SGNS training: pairs and negatives on the device, the
streaming trainer, and its stats."""
