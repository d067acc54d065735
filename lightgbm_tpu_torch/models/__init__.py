"""Tree containers of the port (the growers wait for the training slice)."""
