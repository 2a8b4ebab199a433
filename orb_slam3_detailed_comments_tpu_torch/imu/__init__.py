"""Inertial measurement: preintegration, inertial factors, initialisation."""
