"""Host-side I/O: BMP ingest and JFIF container emission."""
