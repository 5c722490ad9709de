"""Serving of the port: paged stage engines under the Helix ClusterRuntime.

Import the modules directly (``repro_torch.serving.runtime`` and so on);
this package file imports nothing, so loading ``sampling`` alone stays
cheap.
"""
