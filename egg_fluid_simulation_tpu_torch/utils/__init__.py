"""Host-side utilities: logging, math helpers, state audits."""
