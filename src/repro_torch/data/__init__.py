"""Data for the port, counterpart of ``repro.data``: the synthetic series
and the ragged gateway traffic (``synthetic``, a numpy copy of the
reference's).  ``ShardStore`` and ``TokenPipeline`` come with the
training slice (ROADMAP queue 1 item 4)."""
from .synthetic import (  # noqa: F401
    DATASETS,
    DatasetSpec,
    household_power,
    load,
    ragged_sensor_traffic,
)
