"""Serving entry points of the port: the sketch half of the reference's
``serve/engine.py``."""
from .engine import make_ingest_queue, make_sketch_service  # noqa: F401
