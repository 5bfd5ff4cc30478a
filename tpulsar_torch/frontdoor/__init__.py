"""The front door — counterpart of tpulsar/frontdoor/: the pluggable
TicketQueue interface with its spool and in-memory backends
(queue.py) and the durable SQLite backend (sqlite_queue.py), the
tenant claim policy (tenancy.py), the HTTP gateway (gateway.py), the
result store it serves (results.py), the federation router
(federation.py) and the urllib client (client.py).  Nothing here
touches the device: the gateway and the router run on hosts with no
GPU."""
