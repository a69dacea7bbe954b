"""FN-Multi round runner with checkpoint and resume."""
