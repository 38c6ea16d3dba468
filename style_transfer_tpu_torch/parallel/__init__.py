"""Spatial sharding of the image over several devices, one process each
(``mesh.py``), their start (``launch.py``) and torchrun's environment
(``multihost.py``)."""
