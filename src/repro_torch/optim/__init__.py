"""Optimizers, schedules and gradient compression."""
