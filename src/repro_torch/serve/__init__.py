"""Serving entry points of the port (the reference's ``serve/engine.py``):
LM serving for the dense family and the sketch service."""
from .engine import (BatchedServer, Request,  # noqa: F401
                     make_ingest_queue, make_sketch_service, serve_decode_step,
                     serve_prefill)
