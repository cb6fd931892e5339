"""Speech feature frontend of the port."""
