"""Telemetry for the port: the span and event sink (``spans.py``), the
timing reservoir (``registry.py``) and the JSONL reader (``trace.py``),
copies of the parts of the JAX package's ``telemetry/`` that serving
uses."""
