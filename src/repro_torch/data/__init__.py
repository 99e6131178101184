"""The synthetic token pipeline (counterpart of ``repro.data``)."""
