from repro_torch.data.weather import WeatherSpec, build_database  # noqa: F401
