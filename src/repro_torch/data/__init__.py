"""Graph spec registry, the versioned GraphStore and edge-delta batches."""
