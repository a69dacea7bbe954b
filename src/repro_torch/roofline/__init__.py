"""Analytic traffic models of the walk and the sharded trainer."""
