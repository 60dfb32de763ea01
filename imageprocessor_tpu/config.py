"""Environment-variable configuration with validation.

Mirrors the reference's env-only config (reference: internal/config/config.go:12-82,
.env.example:1-38): same variable names for the shared surface (SERVER_*, POSTGRES_*,
RETRIES_*, MINIO_*, KAFKA_*, WORKER_CONCURRENCY), plus device-pipeline knobs that have no
reference counterpart (batching, bucketing, device-mesh axes). `load()` raises
`ConfigError` listing every missing/invalid required variable, like the reference's
`MustLoad` validator pass (config.go:54-64).

Backend selection is explicit so the framework runs with zero external services:
  STORAGE_BACKEND = localfs | s3          (reference always used MinIO/S3)
  METADATA_BACKEND = sqlite | postgres    (reference always used Postgres)
  BROKER_BACKEND  = memory | sqlite | kafka (reference always used Kafka)
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

from imageprocessor_tpu.utils.retrying import RetryStrategy


class ConfigError(ValueError):
    pass


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|\u00b5s|ms|s|m|h)")
_DURATION_UNITS = {"ns": 1e-9, "us": 1e-6, "\u00b5s": 1e-6,
                   "ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(value: str) -> float:
    """Parse Go-style durations ("30s", "5m", "1h30m", "1500ms") to seconds."""
    value = value.strip()
    if not value:
        raise ValueError("empty duration")
    if value == "0":
        return 0.0
    pos, total = 0, 0.0
    for m in _DURATION_RE.finditer(value):
        if m.start() != pos:
            raise ValueError(f"invalid duration {value!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(value):
        raise ValueError(f"invalid duration {value!r}")
    return total


def _parse_bool(value: str) -> bool:
    """Strict: unknown values raise instead of silently meaning False —
    MINIO_USE_SSL=enabled quietly parsing to False would send
    credentials over plaintext with no warning."""
    v = value.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"expected a boolean (true/false/1/0/yes/no/on/off), got {value!r}")


@dataclass
class ServerConfig:
    addr: str = "8034"
    read_timeout_s: float = 30.0
    write_timeout_s: float = 30.0
    idle_timeout_s: float = 60.0
    shutdown_timeout_s: float = 10.0

    @property
    def port(self) -> int:
        # Reference treats SERVER_PORT as both port and addr suffix (app.go uses ":"+addr)
        return int(self.addr.lstrip(":"))


@dataclass
class DatabaseConfig:
    backend: str = "sqlite"  # sqlite | postgres
    sqlite_path: str = "data/metadata.db"
    host: str = "localhost"
    port: int = 5432
    user: str = "postgres"
    password: str = ""
    dbname: str = "image_processor"
    max_open_conns: int = 10

    def dsn(self) -> str:
        """Postgres DSN, same shape as reference config.go:67-70."""
        return (
            f"postgres://{self.user}:{self.password}@{self.host}:{self.port}/"
            f"{self.dbname}?sslmode=disable"
        )


@dataclass
class StorageConfig:
    backend: str = "localfs"  # localfs | s3
    localfs_root: str = "data/objects"
    endpoint: str = "localhost:9000"
    region: str = "us-east-1"
    access_key: str = ""
    secret_key: str = ""
    bucket: str = "images"
    use_ssl: bool = False
    # fsync each object before the atomic rename (default): a crash
    # can otherwise commit a name whose bytes never reached disk.
    # LOCALFS_FSYNC=0 trades that durability for ~10-15 ms lower
    # per-image latency on slow disks (dev/throwaway deployments).
    localfs_fsync: bool = True


@dataclass
class BrokerConfig:
    backend: str = "sqlite"  # memory | sqlite | kafka
    sqlite_path: str = "data/broker.db"
    brokers: list[str] = field(default_factory=lambda: ["localhost:9092"])
    processing_topic: str = "image-processing"
    results_topic: str = "image-processed"
    group_id: str = "image-processor-group"
    partitions: int = 3  # reference creates 3-partition topics (Makefile:24-25)
    # 0 = commit on every ack (dev/in-process brokers; RTT ~0).
    # >0 = coalesce watermark commits to at most one per interval per
    # partition (remote brokers: each ack's commit RTT otherwise caps
    # completions at ~1/RTT); flushed on rebalance/close. A crash
    # before a flush only REDELIVERS acked work (idempotent), never
    # loses it.
    commit_interval_ms: int = 0


@dataclass
class WorkerConfig:
    # Host-side decode/encode pool width. The reference's WORKER_CONCURRENCY
    # goroutine pool (worker.go:88-96) maps to the codec thread pool here;
    # device parallelism comes from batching, not threads.
    concurrency: int = 3
    batch_size: int = 32          # max images per device micro-batch
    batch_deadline_ms: float = 25  # flush partial batch after this long
    max_queue_depth: int = 256
    # Broker lease per delivered message: a crashed worker's in-flight
    # messages redeliver after this long (at-least-once recovery bound).
    lease_s: float = 300.0
    commit_interval_ms: float = 200
    # Optional completion push: POST each ProcessingResult JSON here
    # (retry-wrapped; failures are logged, never fatal).
    webhook_url: str = ""
    # Hung-device-step watchdog: a device RPC that blocks longer than
    # this aborts the process (exit 70) so the supervisor restarts it
    # and leased messages redeliver. Generous default: a cold 12 MP
    # fused-program compile can take minutes. 0 disables.
    device_step_timeout_s: float = 900.0


@dataclass
class DeviceConfig:
    # "" = let JAX pick; "gpu" requires a GPU (the worker exits if JAX
    # comes up elsewhere); "cpu" forces the host.
    platform: str = ""
    data_axis: int = 0            # mesh axis size 0 = all local GPUs
    space_axis: int = 1           # spatial-parallel axis (1 = off)


@dataclass
class Config:
    server: ServerConfig = field(default_factory=ServerConfig)
    db: DatabaseConfig = field(default_factory=DatabaseConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    broker: BrokerConfig = field(default_factory=BrokerConfig)
    worker: WorkerConfig = field(default_factory=WorkerConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    retries_attempts: int = 3
    retries_delay_ms: int = 2000
    retries_backoff: float = 2.0
    log_level: str = "info"

    def retry_strategy(self) -> RetryStrategy:
        """Reference: config.go:76-82 DefaultRetryStrategy."""
        return RetryStrategy(
            attempts=self.retries_attempts,
            delay_ms=self.retries_delay_ms,
            backoff=self.retries_backoff,
        )


def _get(env: Mapping[str, str], key: str, cast: Callable[[str], Any], current: Any,
         errors: list[str]) -> Any:
    raw = env.get(key)
    if raw is None or raw == "":
        return current
    try:
        return cast(raw)
    except (ValueError, TypeError) as exc:
        errors.append(f"{key}: {exc}")
        return current


def load(env: Mapping[str, str] | None = None, *, require: bool = False) -> Config:
    """Build a Config from environment variables.

    With require=True, the reference's `validate:"required"` fields
    (config.go:14-47) must be present — used by the real service entrypoints;
    tests and the standalone single-process mode use permissive defaults.
    """
    env = dict(os.environ if env is None else env)
    errors: list[str] = []
    cfg = Config()

    cfg.server.addr = env.get("SERVER_PORT", cfg.server.addr)
    cfg.server.read_timeout_s = _get(env, "SERVER_READ_TIMEOUT", parse_duration,
                                     cfg.server.read_timeout_s, errors)
    cfg.server.write_timeout_s = _get(env, "SERVER_WRITE_TIMEOUT", parse_duration,
                                      cfg.server.write_timeout_s, errors)
    cfg.server.idle_timeout_s = _get(env, "SERVER_IDLE_TIMEOUT", parse_duration,
                                     cfg.server.idle_timeout_s, errors)
    cfg.server.shutdown_timeout_s = _get(env, "SERVER_SHUTDOWN_TIMEOUT", parse_duration,
                                         cfg.server.shutdown_timeout_s, errors)

    cfg.db.backend = env.get("METADATA_BACKEND", cfg.db.backend).lower()
    cfg.db.sqlite_path = env.get("METADATA_SQLITE_PATH", cfg.db.sqlite_path)
    cfg.db.host = env.get("POSTGRES_HOST", cfg.db.host)
    cfg.db.port = _get(env, "POSTGRES_PORT", int, cfg.db.port, errors)
    cfg.db.user = env.get("POSTGRES_USER", cfg.db.user)
    cfg.db.password = env.get("POSTGRES_PASSWORD", cfg.db.password)
    cfg.db.dbname = env.get("POSTGRES_DB", cfg.db.dbname)
    cfg.db.max_open_conns = _get(env, "DB_MAX_OPEN_CONNS", int, cfg.db.max_open_conns, errors)

    cfg.storage.backend = env.get("STORAGE_BACKEND", cfg.storage.backend).lower()
    cfg.storage.localfs_root = env.get("STORAGE_LOCALFS_ROOT", cfg.storage.localfs_root)
    cfg.storage.endpoint = env.get("MINIO_ENDPOINT", cfg.storage.endpoint)
    cfg.storage.region = env.get("MINIO_REGION", cfg.storage.region)
    cfg.storage.access_key = env.get("MINIO_ACCESS_KEY", cfg.storage.access_key)
    cfg.storage.secret_key = env.get("MINIO_SECRET_KEY", cfg.storage.secret_key)
    cfg.storage.bucket = env.get("MINIO_BUCKET", cfg.storage.bucket)
    cfg.storage.use_ssl = _get(env, "MINIO_USE_SSL", _parse_bool, cfg.storage.use_ssl, errors)
    cfg.storage.localfs_fsync = _get(env, "LOCALFS_FSYNC", _parse_bool,
                                     cfg.storage.localfs_fsync, errors)

    cfg.broker.backend = env.get("BROKER_BACKEND", cfg.broker.backend).lower()
    cfg.broker.sqlite_path = env.get("BROKER_SQLITE_PATH", cfg.broker.sqlite_path)
    if env.get("KAFKA_BROKERS"):
        cfg.broker.brokers = [b.strip() for b in env["KAFKA_BROKERS"].split(",") if b.strip()]
    cfg.broker.processing_topic = env.get("KAFKA_PROCESSING_TOPIC", cfg.broker.processing_topic)
    cfg.broker.results_topic = env.get("KAFKA_RESULTS_TOPIC", cfg.broker.results_topic)
    cfg.broker.group_id = env.get("KAFKA_GROUP_ID", cfg.broker.group_id)
    cfg.broker.partitions = _get(env, "BROKER_PARTITIONS", int, cfg.broker.partitions, errors)
    cfg.broker.commit_interval_ms = _get(
        env, "KAFKA_COMMIT_INTERVAL",
        lambda v: int(parse_duration(v) * 1000),
        cfg.broker.commit_interval_ms, errors)

    cfg.worker.concurrency = _get(env, "WORKER_CONCURRENCY", int, cfg.worker.concurrency, errors)
    cfg.worker.batch_size = _get(env, "WORKER_BATCH_SIZE", int, cfg.worker.batch_size, errors)
    cfg.worker.webhook_url = env.get("WEBHOOK_URL", cfg.worker.webhook_url)
    cfg.worker.batch_deadline_ms = _get(env, "WORKER_BATCH_DEADLINE_MS", float,
                                        cfg.worker.batch_deadline_ms, errors)
    cfg.worker.max_queue_depth = _get(env, "WORKER_MAX_QUEUE_DEPTH", int,
                                      cfg.worker.max_queue_depth, errors)
    cfg.worker.lease_s = _get(env, "WORKER_LEASE_S", float,
                              cfg.worker.lease_s, errors)
    cfg.worker.device_step_timeout_s = _get(
        env, "DEVICE_STEP_TIMEOUT", parse_duration,
        cfg.worker.device_step_timeout_s, errors)

    cfg.device.platform = env.get("DEVICE_PLATFORM", cfg.device.platform)
    cfg.device.data_axis = _get(env, "DEVICE_DATA_AXIS", int, cfg.device.data_axis, errors)
    cfg.device.space_axis = _get(env, "DEVICE_SPACE_AXIS", int, cfg.device.space_axis, errors)

    cfg.retries_attempts = _get(env, "RETRIES_ATTEMPTS", int, cfg.retries_attempts, errors)
    cfg.retries_delay_ms = _get(env, "RETRIES_DELAY_MS", int, cfg.retries_delay_ms, errors)
    cfg.retries_backoff = _get(env, "RETRIES_BACKOFF", float, cfg.retries_backoff, errors)
    cfg.log_level = env.get("LOG_LEVEL", cfg.log_level).lower()

    if require:
        required = ["SERVER_PORT", "SERVER_READ_TIMEOUT", "SERVER_WRITE_TIMEOUT",
                    "SERVER_IDLE_TIMEOUT", "SERVER_SHUTDOWN_TIMEOUT",
                    "RETRIES_ATTEMPTS", "RETRIES_DELAY_MS", "RETRIES_BACKOFF"]
        if cfg.db.backend == "postgres":
            required += ["POSTGRES_HOST", "POSTGRES_PORT", "POSTGRES_USER",
                         "POSTGRES_PASSWORD", "POSTGRES_DB"]
        if cfg.storage.backend == "s3":
            required += ["MINIO_ENDPOINT", "MINIO_REGION", "MINIO_ACCESS_KEY",
                         "MINIO_SECRET_KEY"]
        if cfg.broker.backend == "kafka":
            required += ["KAFKA_BROKERS"]
        missing = [k for k in required if not env.get(k)]
        if missing:
            errors.append(f"missing required variables: {', '.join(sorted(set(missing)))}")

    if cfg.db.backend not in ("sqlite", "postgres"):
        errors.append(f"METADATA_BACKEND must be sqlite|postgres, got {cfg.db.backend!r}")
    if cfg.storage.backend not in ("localfs", "s3"):
        errors.append(f"STORAGE_BACKEND must be localfs|s3, got {cfg.storage.backend!r}")
    if cfg.broker.backend not in ("memory", "sqlite", "kafka"):
        errors.append(f"BROKER_BACKEND must be memory|sqlite|kafka, got {cfg.broker.backend!r}")
    if cfg.worker.batch_size < 1:
        errors.append("WORKER_BATCH_SIZE must be >= 1")
    if cfg.worker.device_step_timeout_s < 0:
        errors.append("DEVICE_STEP_TIMEOUT must be >= 0 (0 disables)")
    try:
        port = cfg.server.port
        if not (0 < port < 65536):
            errors.append(f"SERVER_PORT must be 1..65535, got {port}")
    except ValueError:
        errors.append(f"SERVER_PORT must be a port number, got {cfg.server.addr!r}")

    if errors:
        raise ConfigError("config validation failed: " + "; ".join(errors))
    return cfg


def apply_device_platform(cfg: Config, _jax=None) -> bool:
    """Force the configured JAX platform (DEVICE_PLATFORM, "gpu" or
    "cpu"). Must run BEFORE the first jax.devices()/jit call in the
    process. Returns True when a platform was forced; the worker then
    checks the backend JAX came up on (runtime/device.require_platform).
    """
    if not cfg.device.platform:
        return False
    if _jax is None:  # pragma: no branch - test seam
        import jax as _jax
    _jax.config.update("jax_platforms", cfg.device.platform)
    return True
