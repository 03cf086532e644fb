"""Host utilities of the port: JSON IO and logging setup."""
