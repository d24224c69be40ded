"""The fault-tolerance runtime and elastic restarts."""
