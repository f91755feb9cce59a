"""Host utilities of the port: metrics, checkpoints, the config-5 sweep and multi-seed runs."""
