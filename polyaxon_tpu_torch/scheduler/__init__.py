"""The reference's scheduler, own copies: the run queues (queue.py), the
agent's loop (agent.py), schedules (schedules.py), the fleet, its
admission control and their simulator (fleet.py, admission.py, sim.py,
clock.py), DAG execution (dag.py), joins over past runs (joins.py) and
the block math of placement (topology.py)."""

from .agent import Agent  # noqa: F401
from .dag import DagError, execute_dag, topo_order  # noqa: F401
from .joins import JoinError, query_runs, resolve_joins  # noqa: F401
from .queue import RunQueue  # noqa: F401
from .schedules import ScheduleError, ScheduleRegistry  # noqa: F401
