"""Fault injection (``chaos.py``) and the transient-failure class it
raises (``retry.py``): the parts of the JAX package's ``resilience/``
that the batch scorer's and the server's kill sites use."""
