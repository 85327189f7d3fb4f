"""Pipeline orchestration: region processing, chromosome driver, CLI."""
