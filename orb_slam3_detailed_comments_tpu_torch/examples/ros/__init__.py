"""Launchers of the ROS nodes, one module per reference node."""
