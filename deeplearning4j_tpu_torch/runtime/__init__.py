"""Runtime services of the port: telemetry, fault seams and the
resilient training harness (``resilience``)."""
