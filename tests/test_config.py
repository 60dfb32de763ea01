"""Config loading/validation tests (reference semantics: config.go:12-82)."""

import pytest

from imageprocessor_tpu.config import ConfigError, load, parse_duration


def test_defaults_load_without_env():
    cfg = load({})
    assert cfg.server.port == 8034
    assert cfg.worker.concurrency == 3
    assert cfg.broker.partitions == 3
    assert cfg.retry_strategy().attempts == 3
    assert cfg.retry_strategy().delay_ms == 2000
    assert cfg.retry_strategy().backoff == 2.0


def test_env_example_values_parse():
    env = {
        "SERVER_PORT": "8034",
        "SERVER_READ_TIMEOUT": "30s",
        "SERVER_WRITE_TIMEOUT": "30s",
        "SERVER_IDLE_TIMEOUT": "60s",
        "SERVER_SHUTDOWN_TIMEOUT": "10s",
        "RETRIES_ATTEMPTS": "3",
        "RETRIES_DELAY_MS": "2000",
        "RETRIES_BACKOFF": "2",
        "KAFKA_BROKERS": "kafka:9092,kafka2:9092",
        "WORKER_CONCURRENCY": "5",
    }
    cfg = load(env)
    assert cfg.server.read_timeout_s == 30.0
    assert cfg.server.idle_timeout_s == 60.0
    assert cfg.broker.brokers == ["kafka:9092", "kafka2:9092"]
    assert cfg.worker.concurrency == 5


def test_require_flags_missing_vars():
    with pytest.raises(ConfigError) as exc:
        load({"METADATA_BACKEND": "postgres"}, require=True)
    assert "POSTGRES_HOST" in str(exc.value)


def test_postgres_dsn_shape():
    cfg = load({"POSTGRES_HOST": "db", "POSTGRES_PORT": "5433",
                "POSTGRES_USER": "u", "POSTGRES_PASSWORD": "p",
                "POSTGRES_DB": "imgs"})
    assert cfg.db.dsn() == "postgres://u:p@db:5433/imgs?sslmode=disable"


def test_invalid_backend_rejected():
    with pytest.raises(ConfigError):
        load({"BROKER_BACKEND": "rabbitmq"})


def test_parse_duration():
    assert parse_duration("30s") == 30.0
    assert parse_duration("1500ms") == 1.5
    assert parse_duration("1h30m") == 5400.0
    assert parse_duration("5m") == 300.0
    with pytest.raises(ValueError):
        parse_duration("abc")


def test_retry_strategy_delays():
    cfg = load({"RETRIES_ATTEMPTS": "3", "RETRIES_DELAY_MS": "100",
                "RETRIES_BACKOFF": "2"})
    assert cfg.retry_strategy().delays() == [0.1, 0.2]


def test_apply_device_platform_forces_jax_config():
    # DEVICE_PLATFORM=cpu must translate into a jax.config.update call,
    # so the switch holds even where JAX_PLATFORMS is set otherwise.
    from imageprocessor_tpu.config import apply_device_platform

    calls = []

    class FakeConfig:
        def update(self, key, value):
            calls.append((key, value))

    class FakeJax:
        config = FakeConfig()

    cfg = load({"DEVICE_PLATFORM": "cpu"})
    assert cfg.device.platform == "cpu"
    assert apply_device_platform(cfg, _jax=FakeJax()) is True
    assert calls == [("jax_platforms", "cpu")]

    cfg = load({})
    assert apply_device_platform(cfg, _jax=FakeJax()) is False
    assert calls == [("jax_platforms", "cpu")]  # untouched
