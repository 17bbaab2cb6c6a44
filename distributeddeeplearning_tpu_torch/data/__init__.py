"""Input pipelines of the port: the synthetic text set (``synthetic``)."""
