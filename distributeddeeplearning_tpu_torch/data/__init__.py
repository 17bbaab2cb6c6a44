"""Input pipelines of the port: the synthetic image and text sets
(``synthetic``)."""
