"""The reference's scheduler, own copies: the run queues the store reads
(queue.py), DAG execution (dag.py), joins over past runs (joins.py) and the
block math of trial placement (topology.py)."""

from .dag import DagError, execute_dag, topo_order  # noqa: F401
from .joins import JoinError, query_runs, resolve_joins  # noqa: F401
