"""Matching core of the port: reference database, filters, DTW."""
