"""Distribution for the port, counterpart of ``repro.parallel``:
logical-axis rules and partition specs over a torch DeviceMesh
(``sharding``, ``partition``) and the serving fleet's series->shard
placement (``fleet``)."""
from .sharding import AxisRules, axis_rules, make_rules, shard  # noqa: F401
from .partition import param_specs, param_shardings, fsdp_axes_for  # noqa: F401
from .fleet import FleetPlan, plan_fleet, shard_of  # noqa: F401
