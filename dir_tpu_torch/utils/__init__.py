"""Logging and visualization helpers of the port."""
