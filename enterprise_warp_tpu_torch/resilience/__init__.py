"""Resilience: the ingestion-audit quarantine gate (``integrity``)."""
