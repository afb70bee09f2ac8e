"""The fleet knobs' defaults, the one table of them (standard library
only): `config.py` registers the knobs from it, and `fleet.py`, whose
router half the launcher loads by file path with no package around it,
reads each knob from its environment variable `MXNET_TPU_<NAME>`."""

DEFAULTS = {
    "fleet": "off",
    "fleet_port": 8900,
    "fleet_retry_max": 3,
    "fleet_health_interval_ms": 250.0,
    "fleet_stall_timeout_ms": 10000.0,
    "fleet_drain_grace_s": 30.0,
    "fleet_autoscale": "off",
    "fleet_autoscale_p99_ms": 500.0,
    "fleet_autoscale_window_s": 5.0,
}
