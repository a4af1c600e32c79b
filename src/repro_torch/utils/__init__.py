"""Utilities: the analytic cost model and the roofline terms."""
