"""Front end: telemetry ingest and its probe, lens profiles, gyro
integration and axis conventions, and the LK tracker with rolling-shutter
timestamps and ray lifting."""
