"""Front end: gyro integration and axis conventions, and the LK tracker
with rolling-shutter timestamps and ray lifting."""
