"""The cells' drivers, one module a kind of traffic, found by the
workload's ``kind``: ``trainer`` (the Trainer's closed loop of steps) and
``serve_closed`` (clients in a closed loop against the render server,
with ``serve_client`` their standard-library process)."""
