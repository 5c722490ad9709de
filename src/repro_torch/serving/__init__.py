"""Serving of the port: paged and dense stage engines under the Helix
ClusterRuntime with its autoscaler, and the single-node ``Engine`` and
``PagedEngine``.

Import the modules directly (``repro_torch.serving.runtime`` and so on);
this package file imports nothing, so loading ``sampling`` alone stays
cheap.
"""
