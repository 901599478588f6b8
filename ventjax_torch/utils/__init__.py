"""Operational helpers of the port: the stall watchdog, the deployment
self-check (doctor) and the tracing helpers."""
