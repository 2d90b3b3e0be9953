"""Host-side helpers of the port (``env.py``: the ``.env`` loader)."""
