"""Message broker abstraction with pluggable backends.

Mirrors the reference's broker layer (reference: internal/broker/broker.go:9-26
Producer/Consumer/Message; internal/broker/kafka/*) with the same topology:
named topics ("image-processing"/"image-processed"), N partitions (3 by
default, Makefile:24-25), consumer groups, messages keyed by image id so one
image's tasks stay ordered, and at-least-once delivery — a message is
redelivered unless acked after successful processing (worker.go:125-146).

Backends:
* memory — in-process, for the standalone single-binary mode and tests;
* sqlite — durable on-disk queue with lease-based redelivery (survives
  restarts; per-message acks avoid the reference's commit/offset race,
  SURVEY.md §5 "race detection");
* kafka — pure-Python wire-protocol client (broker/kafka.py over
  broker/kafkawire.py): consumer-group membership, range assignment,
  keyed produce, watermark commits — drops into the reference's Kafka
  deployment with no client library. broker/kafkaserver.py is a
  wire-compatible in-process single-node broker for tests/dev.

The consume surface is deliberately batch-oriented (`poll(max_n)`) because
the device engine wants micro-batches, not a per-message channel.
"""

from imageprocessor_tpu.broker.base import Broker, BrokerMessage, build_broker
from imageprocessor_tpu.broker.memory import MemoryBroker
from imageprocessor_tpu.broker.sqlitebroker import SQLiteBroker

__all__ = ["Broker", "BrokerMessage", "MemoryBroker", "SQLiteBroker", "build_broker"]
