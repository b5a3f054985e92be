"""The port's apps (counterparts of app/*/main_*.py)."""
