"""Serving: decode step, KV pager, scheduler and the continuous-batching
engine."""
