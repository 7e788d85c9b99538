"""Architecture configs: plain-data copies of the reference's configs."""
