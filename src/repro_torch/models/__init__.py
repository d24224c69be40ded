"""Model layers, attention, transformer assembly and the ``Model`` API."""
