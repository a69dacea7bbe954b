"""Graph containers, alias tables, transition probabilities, walks."""
