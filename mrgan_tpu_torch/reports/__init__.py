"""Paper figures (``reports.plots``)."""
