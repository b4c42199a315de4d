"""Controller API: the DASE contracts engine templates implement.

The port's counterpart of ``predictionio_tpu/controller``. It exports what
the templates, ``Engine.train`` and a server built from a ``TrainResult``
need; evaluation, metrics and fast_eval come with the evaluation slice.
"""

from .components import (Algorithm, DataSource, FirstServing, Preparator,
                         SanityCheck)
from .engine import Engine, TrainResult
from .params import EngineParams, Params

__all__ = ["Algorithm", "DataSource", "Engine", "EngineParams",
           "FirstServing", "Params", "Preparator", "SanityCheck",
           "TrainResult"]
