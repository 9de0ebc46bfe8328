"""End-to-end codec pipelines of the port (shared-table video decode)."""
