"""Launchers of the port: the step factories (``launch/steps.py``), the
training launcher (``launch/train.py``) and the serving launcher
(``launch/serve.py``)."""
