"""DEM-source helpers. Only the projection math (:mod:`.geodesy`) is ported;
the DEM fetchers wait for the CLI's network layer."""
