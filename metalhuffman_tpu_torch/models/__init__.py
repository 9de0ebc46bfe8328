"""End-to-end codec pipelines of the port: video containers, the image
codec, color and 16-bit planes, temporal video."""
