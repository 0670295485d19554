"""The synthetic token pipeline (``pipeline``), a copy of the reference's."""
