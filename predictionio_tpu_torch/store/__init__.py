"""Event store facade (L2) — what engine templates read (reference:
data/src/main/scala/io/prediction/data/store/).

Copied from ``predictionio_tpu/store/__init__.py``; the port imports
nothing of the JAX package.
"""

from .event_store import EventStore, app_name_to_id

__all__ = ["EventStore", "app_name_to_id"]
