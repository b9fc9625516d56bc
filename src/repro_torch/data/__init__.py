"""Data for the port, counterpart of ``repro.data``: the synthetic series
and the ragged gateway traffic (``synthetic``, a numpy copy of the
reference's), the token pipeline and the SHRINK shard store
(``pipeline``)."""
from .synthetic import (  # noqa: F401
    DATASETS,
    DatasetSpec,
    household_power,
    load,
    ragged_sensor_traffic,
)
from .pipeline import ShardStore, TokenPipeline  # noqa: F401
