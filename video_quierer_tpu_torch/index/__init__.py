"""Device-resident frame index of the port."""
