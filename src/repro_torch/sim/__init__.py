"""Event-driven serving simulator for heterogeneous clusters.

A copy of ``repro.sim`` (pure Python) so the port imports nothing of the
JAX package.
"""
from .simulator import LinkSim, Metrics, NodeSim, Simulator
from .traces import (TraceRequest, azure_conversation_lengths, make_offline_trace,
                     make_trace, online_rate_for_cluster)
