"""Graph spec registry and the read-only GraphStore."""
