"""Launchers of the port: the serving launcher (``launch/serve.py``)."""
