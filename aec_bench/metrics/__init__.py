"""Per-layer metric readers, one module per metric name (up to its first
dot). Each has ``read(reading) -> float | None``; ``reading`` holds the
traced window's reduction (``trace``), the configuration (``cfg``), the
traffic (``mix``), the window's work (``work``) and the driver's host-side
records (``host``). None means nothing to read: the metric is left out."""
