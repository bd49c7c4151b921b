"""Model definitions of the port: configs, layers, the recurrent mixers and
the model assembly (``transformer``)."""
