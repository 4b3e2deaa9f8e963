"""Input types and the feeder that turns samples into device Arguments."""
