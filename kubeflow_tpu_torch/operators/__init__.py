"""What the port needs of the TpuJob operator: the checkpointer interface
the elastic plane binds, and the CR's API version and kind."""
