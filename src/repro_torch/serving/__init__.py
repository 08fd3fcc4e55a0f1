"""Serving of the port: the paged KV pool and the continuous-batching
engine."""
