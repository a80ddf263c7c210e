// Host message transport: the native runtime piece of round_tpu.
//
// Reference parity: psync's runtime moves 8-byte-Tag + payload packets over
// Netty TCP channels with length-field framing and a connection handshake
// (TcpRuntime.scala:27-232, Tag.scala:22-25, Message.scala:15-80).  This is
// the same wire discipline as a self-contained C++ library driven from
// Python over ctypes (runtime/transport.py):
//
//   frame     := u32_be length | u64_be tag | payload bytes
//   handshake := u32_be node id | u32_be listen port, sent by the
//                connecting side first (the reference sends "host:port";
//                id + listen port is the same information under the
//                Directory's id->address map, Replicas.scala:74-80).  The
//                listen port matters under LIVE RECONFIGURATION
//                (runtime/view.py): ids are renamed to stay contiguous
//                when the group changes, so an id alone no longer proves
//                identity — a removed replica redialing with its stale id
//                would hijack the by_peer slot of whichever CURRENT
//                member inherited that id ("newest channel wins" routes
//                its traffic to the wrong node).  The acceptor therefore
//                validates the advertised listen port against its peer
//                table and closes mismatched channels as stale.
//
// Differences from the reference, by design: 4-byte length framing instead
// of 2 (no 64 KiB payload cap), connect-on-demand from either side instead
// of the lower-id-connects rule (duplicate channels are harmless: both are
// read, sends use the newest), and a poll(2) event loop thread instead of
// epoll/NIO event-loop groups (peer counts here are small).
//
// UDP mode (rt_node_create_udp) mirrors the reference's default perf
// transport (UdpRuntime.scala:19-96): one datagram socket per node, packet
// := u32_be sender id | u64_be tag | payload (datagram boundaries replace
// the length field; the explicit sender id replaces the TCP handshake under
// the same trust model), drop-tolerant by construction — no reconnect, no
// delivery guarantee, payloads capped at one datagram (~64 KiB).
//
// Threading model (one object = one node):
//   * one event-loop thread owns ALL socket reads + accepts (poll loop),
//   * senders write from their calling thread under a per-connection mutex
//     (full-duplex sockets: concurrent read from the loop is safe),
//   * received messages land in a mutex+condvar inbox drained by
//     rt_node_recv (the InstanceHandler's ArrayBlockingQueue analogue,
//     InstanceHandler.scala:45).

// TLS mode (rt_node_create_tls) is the reference's TCP_SSL
// (TcpRuntime.scala:143-158, RuntimeOptions.scala:51-67): the same framed
// protocol inside a TLS channel.  libssl is loaded with dlopen/dlsym — this
// build environment ships the OpenSSL 3 runtime but not its headers — and
// certificates are PEM paths supplied by the caller (runtime/transport.py
// generates a self-signed pair when none is given, the SelfSignedCertificate
// fallback of the reference).  Like the reference's insecure-trust default
// for self-signed deployments, peers do not verify the certificate chain
// (OpenSSL's SSL_VERIFY_NONE default) — TLS here provides channel privacy
// and integrity, not peer authentication.

// NATIVE ROUND PUMP (rt_pump_*): the per-round wire state machine, moved
// out of Python.  PERF_MODEL.md's host-wire roofline showed rounds are
// GIL/scheduler-convoy-bound — the wire work is ~2% of round wall, but
// every received message used to wake a Python thread.  The pump runs the
// RECEIVER side of a communication-closed round inside this event loop:
// FLAG_BATCH containers are split here, payloads are matched against a
// per-(lane, round-class) codec TEMPLATE (runtime/codec.py emits a fixed
// byte layout per payload signature: every structural byte — tags, dtype
// codes, dims, counts, dict keys — is static, only array data varies), and
// matching frames memcpy their array leaves straight into the mailbox
// buffers Python registered BY POINTER (the in-place [n, ...] / [L, n, ...]
// arrays of runtime/host.py::_RoundMailbox / runtime/lanes.py::_ClassBox),
// updating the shared arrival bitmask + count.  Python blocks in ONE call,
// rt_pump_wait, which returns only when some lane crossed its progress
// threshold, its (adaptive) deadline expired, round skew demands catch-up,
// or non-fast-path traffic landed in the regular inbox (misc).  Frames the
// fast path cannot prove safe — unknown instances, non-NORMAL flags,
// template mismatches (legacy-pickle peers, byzantine garbage) — fall back
// to the inbox for the bilingual Python path, so mixed clusters
// interoperate and garbage tolerance is unchanged.  Symmetrically,
// rt_pump_flush ships a whole send wave (encode-once scratch + per-peer
// offset plan) with per-destination FLAG_BATCH coalescing in one ctypes
// crossing.  Ownership discipline: Python writes a lane's mailbox buffers
// only while the lane is DISARMED (reset/self-delivery/prefill before
// rt_pump_arm, update after); while armed, all writes happen here under
// the pump mutex — the two sides never race on the shared buffers.

#include <algorithm>
#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <dlfcn.h>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// libssl via dlopen (no OpenSSL headers in this environment)
// ---------------------------------------------------------------------------

constexpr int kSslFiletypePem = 1;
constexpr int kSslErrorWantRead = 2;
constexpr int kSslErrorWantWrite = 3;

struct TlsApi {
  void *lib = nullptr;
  const void *(*TLS_method)() = nullptr;
  void *(*SSL_CTX_new)(const void *) = nullptr;
  void (*SSL_CTX_free)(void *) = nullptr;
  int (*SSL_CTX_use_certificate_chain_file)(void *, const char *) = nullptr;
  int (*SSL_CTX_use_PrivateKey_file)(void *, const char *, int) = nullptr;
  void *(*SSL_new)(void *) = nullptr;
  void (*SSL_free)(void *) = nullptr;
  int (*SSL_set_fd)(void *, int) = nullptr;
  void (*SSL_set_accept_state)(void *) = nullptr;
  void (*SSL_set_connect_state)(void *) = nullptr;
  int (*SSL_read)(void *, void *, int) = nullptr;
  int (*SSL_write)(void *, const void *, int) = nullptr;
  int (*SSL_get_error)(const void *, int) = nullptr;
  bool ok = false;
};

const TlsApi &tls_api() {
  static TlsApi api = [] {
    TlsApi a;
    a.lib = dlopen("libssl.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (!a.lib) a.lib = dlopen("libssl.so", RTLD_NOW | RTLD_GLOBAL);
    if (!a.lib) return a;
    auto sym = [&](const char *name) { return dlsym(a.lib, name); };
    a.TLS_method = reinterpret_cast<const void *(*)()>(sym("TLS_method"));
    a.SSL_CTX_new =
        reinterpret_cast<void *(*)(const void *)>(sym("SSL_CTX_new"));
    a.SSL_CTX_free = reinterpret_cast<void (*)(void *)>(sym("SSL_CTX_free"));
    a.SSL_CTX_use_certificate_chain_file =
        reinterpret_cast<int (*)(void *, const char *)>(
            sym("SSL_CTX_use_certificate_chain_file"));
    a.SSL_CTX_use_PrivateKey_file =
        reinterpret_cast<int (*)(void *, const char *, int)>(
            sym("SSL_CTX_use_PrivateKey_file"));
    a.SSL_new = reinterpret_cast<void *(*)(void *)>(sym("SSL_new"));
    a.SSL_free = reinterpret_cast<void (*)(void *)>(sym("SSL_free"));
    a.SSL_set_fd = reinterpret_cast<int (*)(void *, int)>(sym("SSL_set_fd"));
    a.SSL_set_accept_state =
        reinterpret_cast<void (*)(void *)>(sym("SSL_set_accept_state"));
    a.SSL_set_connect_state =
        reinterpret_cast<void (*)(void *)>(sym("SSL_set_connect_state"));
    a.SSL_read =
        reinterpret_cast<int (*)(void *, void *, int)>(sym("SSL_read"));
    a.SSL_write = reinterpret_cast<int (*)(void *, const void *, int)>(
        sym("SSL_write"));
    a.SSL_get_error =
        reinterpret_cast<int (*)(const void *, int)>(sym("SSL_get_error"));
    a.ok = a.TLS_method && a.SSL_CTX_new && a.SSL_CTX_free &&
           a.SSL_CTX_use_certificate_chain_file &&
           a.SSL_CTX_use_PrivateKey_file && a.SSL_new && a.SSL_free &&
           a.SSL_set_fd && a.SSL_set_accept_state && a.SSL_set_connect_state &&
           a.SSL_read && a.SSL_write && a.SSL_get_error;
    return a;
  }();
  return api;
}

struct Msg {
  int from;
  uint64_t tag;
  std::vector<uint8_t> payload;
};

// ---------------------------------------------------------------------------
// round pump (see the file-top comment)
// ---------------------------------------------------------------------------

constexpr uint8_t kFlagNormal = 0x00;
constexpr uint8_t kFlagBatch = 0xB7;   // runtime/oob.py FLAG_BATCH

// arm() flags
constexpr uint32_t kPumpGrowth = 1;    // wake on every accepted frame
                                       // (FoldRound go-probes, Sync
                                       // barriers re-check in Python)
constexpr uint32_t kPumpExtend = 2;    // progress extends the deadline
                                       // (the WaitForMessage idle cap)
constexpr uint32_t kPumpStrict = 4;    // no round-skew fast-forward

// ready reason bits (rt_pump_wait reasons_out)
constexpr uint8_t kReadyThresh = 1;    // count >= progress threshold
constexpr uint8_t kReadyGrowth = 2;    // heard-set / attestation progress
constexpr uint8_t kReadySkew = 4;      // next_round > round + 1
constexpr uint8_t kReadyDeadline = 8;  // armed deadline expired
constexpr uint8_t kReadyPoke = 16;     // rt_pump_poke (mux router nudge)
constexpr uint8_t kReadyBackpr = 32;   // inbox crossed its byte high
                                       // watermark: the waiter must drain
                                       // (never in the auto-disarm set —
                                       // backpressure is not a round end)

// stats slots (shared u64[16] registered at enable; Python folds deltas
// into the pump.* metrics vocabulary, docs/OBSERVABILITY.md)
enum {
  kStFast = 0,         // template-matched inserts that grew the heard set
  kStDup = 1,          // duplicate overwrites (heard set unchanged)
  kStPending = 2,      // future-round frames buffered natively
  kStApplied = 3,      // buffered frames applied at arm
  kStFallback = 4,     // frames handed to the inbox (template miss)
  kStLate = 5,         // communication-closed-late drops
  kStMalformed = 6,    // out-of-range sender drops
  kStWaits = 7,        // rt_pump_wait calls
  kStWakesReady = 8,   // waits returning with >= 1 ready lane
  kStWakesMisc = 9,    // waits returning with inbox traffic
  kStBatchSplit = 10,  // FLAG_BATCH containers split natively
  kStBatchMalformed = 11,  // containers with a truncated tail
};

struct PumpHole {
  uint32_t off, len, leaf;
};

struct PumpLeafDst {
  uint8_t *base = nullptr;  // mailbox row base; slot = base + sender*nbytes
  uint32_t nbytes = 0;
};

struct PumpSlot {
  std::vector<uint8_t> tmpl;      // exemplar encoding; holes = array data
  std::vector<PumpHole> holes;    // ascending, non-overlapping
  std::vector<PumpLeafDst> leaves;
  uint8_t *mask = nullptr;        // [n] bool, shared with Python
  long long *count = nullptr;     // &count[lane], shared with Python
};

struct PumpLane {
  int iid = -1;
  bool open_ = false;
  bool armed = false;
  long long round_ = 0;
  int cls = 0;
  long long threshold = 0;        // 0 = never ready by count
  uint32_t flags = 0;
  uint8_t auto_disarm = 0;        // reasons that end the round: reporting
                                  // one of these disarms atomically, so no
                                  // frame can join the mailbox between the
                                  // wait returning and the jitted update
  bool has_deadline = false;
  std::chrono::steady_clock::time_point deadline{};
  int extend_ms = 0;
  uint8_t ready = 0;
  // future-round frames buffered raw per (round, sender); applied (with
  // the full template check) when Python arms that round — the native
  // form of the drivers' `_pending` dicts.  Bounded like the stash.
  std::map<long long, std::map<int, std::vector<uint8_t>>> pending;
  size_t pending_frames = 0;
  std::vector<PumpSlot> slots;    // [k] round classes
};

constexpr size_t kPumpPendingCap = 4096;  // per lane

struct Pump {
  std::mutex mu;
  std::condition_variable cv;
  int L = 0, n = 0, k = 0, nbz = 0;
  std::vector<PumpLane> lanes;
  std::vector<int32_t> iid2lane;       // [65536], -1 = not mapped
  long long *max_rnd = nullptr;        // [L, n] shared with Python
  long long *next_round = nullptr;     // [L] shared with Python
  unsigned long long *stats = nullptr; // [16] shared with Python
  std::atomic<bool> misc{false};       // inbox gained a frame
  std::atomic<bool> stopped{false};
  uint64_t bp_seen = 0;                // backpressure edges already
                                       // reported (guarded by mu)

  void configure(int L_, int n_, int k_, int nbz_, long long *mr,
                 long long *nr, unsigned long long *st) {
    std::lock_guard<std::mutex> l(mu);
    L = L_; n = n_; k = k_; nbz = nbz_;
    max_rnd = mr; next_round = nr; stats = st;
    lanes.assign(L, PumpLane{});
    for (auto &ln : lanes) ln.slots.resize(k);
    iid2lane.assign(1 << 16, -1);
    misc.store(false);
    stopped.store(false);
  }

  // template match + in-place leaf copy; 1 = heard set grew, 0 = duplicate
  // overwrite, -1 = template mismatch (caller falls back to Python)
  int slot_insert(PumpSlot &s, int from, const uint8_t *p, size_t len) {
    if (s.tmpl.empty() || len != s.tmpl.size()) return -1;
    size_t pos = 0;
    for (const auto &h : s.holes) {
      if (h.off > pos &&
          std::memcmp(p + pos, s.tmpl.data() + pos, h.off - pos) != 0)
        return -1;
      pos = h.off + h.len;
    }
    if (pos < len &&
        std::memcmp(p + pos, s.tmpl.data() + pos, len - pos) != 0)
      return -1;
    for (const auto &h : s.holes) {
      const PumpLeafDst &lf = s.leaves[h.leaf];
      std::memcpy(lf.base + static_cast<size_t>(from) * lf.nbytes,
                  p + h.off, h.len);
    }
    if (!s.mask[from]) {
      s.mask[from] = 1;
      ++*s.count;
      return 1;
    }
    return 0;
  }

  void recompute_next_round(int lane_i) {
    long long *mr = max_rnd + static_cast<size_t>(lane_i) * n;
    long long v;
    if (nbz <= 0) {
      v = mr[0];
      for (int i = 1; i < n; ++i) v = std::max(v, mr[i]);
    } else {
      // byzantine catch-up: the (f+1)-th highest claim — f liars cannot
      // drag the lane forward (InstanceHandler.scala:302-307)
      std::vector<long long> row(mr, mr + n);
      std::nth_element(row.begin(), row.begin() + (n - 1 - nbz), row.end());
      v = row[n - 1 - nbz];
    }
    if (v > next_round[lane_i]) next_round[lane_i] = v;
  }

  // caller holds mu.  kind: 0 = wire (template miss -> inbox fallback,
  // return false), 1 = feed from Python (template miss -> return -2, the
  // caller decodes + re-encodes canonically + rt_pump_insert).
  // Returns: 1 consumed, 0 not pump-routable (unknown iid / non-NORMAL),
  // -2 template miss at the armed current round.
  int route_locked(int from, uint64_t tagw, const uint8_t *p, size_t len) {
    if ((tagw & 0xFF) != kFlagNormal) return 0;
    int iid = static_cast<int>((tagw >> 16) & 0xFFFF);
    long long r = static_cast<long long>((tagw >> 32) & 0xFFFFFFFFull);
    int lane_i = iid2lane[iid];
    if (lane_i < 0) return 0;  // unknown instance: stash/TooLate in Python
    PumpLane &ln = lanes[lane_i];
    if (from < 0 || from >= n) {
      // protocol garbage on the unauthenticated socket: an out-of-range
      // id would corrupt every sender-indexed structure
      ++stats[kStMalformed];
      return 1;
    }
    long long *mr = max_rnd + static_cast<size_t>(lane_i) * n;
    if (r > mr[from]) mr[from] = r;
    if (r < ln.round_) {
      ++stats[kStLate];
      return 1;  // late: the round is communication-closed
    }
    bool accepted = false;
    uint8_t newly = 0;
    if (r > ln.round_ || !ln.armed) {
      auto &mp = ln.pending[r];
      auto it = mp.find(from);
      if (it != mp.end()) {
        it->second.assign(p, p + len);  // latest-wins, like the dicts
        accepted = true;
      } else if (ln.pending_frames < kPumpPendingCap) {
        mp.emplace(from, std::vector<uint8_t>(p, p + len));
        ++ln.pending_frames;
        accepted = true;
      }
      if (accepted) ++stats[kStPending];
      if (r > ln.round_) {
        recompute_next_round(lane_i);
        if (ln.armed && !(ln.flags & kPumpStrict) &&
            next_round[lane_i] > ln.round_ + 1)
          newly |= kReadySkew;
      }
    } else {
      int rc = slot_insert(ln.slots[ln.cls], from, p, len);
      if (rc < 0) {
        // the WIRE path counts kStFallback (deliver_one_locked) — not
        // here, or the rt_pump_feed retry of the same frame would count
        // it twice
        return -2;
      }
      accepted = true;
      if (rc == 1) {
        ++stats[kStFast];
        if (ln.threshold > 0 && *ln.slots[ln.cls].count >= ln.threshold)
          newly |= kReadyThresh;
      } else {
        ++stats[kStDup];
      }
    }
    if (accepted && ln.armed) {
      if (ln.flags & kPumpGrowth) newly |= kReadyGrowth;
      if ((ln.flags & kPumpExtend) && ln.extend_ms > 0) {
        ln.deadline = std::chrono::steady_clock::now() +
                      std::chrono::milliseconds(ln.extend_ms);
        ln.has_deadline = true;
      }
    }
    if (newly) {
      ln.ready |= newly;
      cv.notify_all();
    }
    return 1;
  }
};

struct Conn {
  int fd = -1;
  int peer = -1;                  // -1 until the handshake id arrives
  std::vector<uint8_t> rbuf;      // read accumulator (frames + handshake)
  bool handshaked = false;
  std::mutex wmu;                 // serializes writes from sender threads
  // TLS state: `ssl` is the channel; an SSL object is NOT safe for
  // concurrent SSL_read/SSL_write, so smu serializes the event loop's
  // reads against sender-thread writes (plaintext conns never take it)
  void *ssl = nullptr;
  std::mutex smu;

  ~Conn() {
    if (ssl) tls_api().SSL_free(ssl);
  }
};

// SSL_write with a NONBLOCKING fd: retry WANT_READ/WANT_WRITE with a short
// poll until done or the deadline (TLS handshakes piggyback on the first
// write — connect-state conns handshake here).  Caller holds c.smu.
bool ssl_write_all(Conn &c, const uint8_t *p, size_t len, int timeout_ms) {
  const TlsApi &api = tls_api();
  auto deadline =
      std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  size_t off = 0;
  while (off < len) {
    int k = api.SSL_write(c.ssl, p + off, static_cast<int>(len - off));
    if (k > 0) {
      off += static_cast<size_t>(k);
      continue;
    }
    int err = api.SSL_get_error(c.ssl, k);
    if (err != kSslErrorWantRead && err != kSslErrorWantWrite) return false;
    if (std::chrono::steady_clock::now() >= deadline) return false;
    pollfd pfd{c.fd, static_cast<short>(
        err == kSslErrorWantRead ? POLLIN : POLLOUT), 0};
    poll(&pfd, 1, 50);
  }
  return true;
}

bool write_all(int fd, const uint8_t *p, size_t len) {
  while (len > 0) {
    ssize_t k = ::send(fd, p, len, MSG_NOSIGNAL);
    if (k < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += k;
    len -= static_cast<size_t>(k);
  }
  return true;
}

void put_u32(std::vector<uint8_t> &b, uint32_t v) {
  b.push_back(v >> 24); b.push_back(v >> 16); b.push_back(v >> 8);
  b.push_back(v);
}

uint32_t get_u32(const uint8_t *p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

uint64_t get_u64(const uint8_t *p) {
  return (uint64_t(get_u32(p)) << 32) | get_u32(p + 4);
}

struct Node {
  int id;
  int listen_port = 0;            // resolved at bind; advertised in hellos
  int listen_fd = -1;             // TCP listen socket, or the UDP socket
  bool udp = false;
  bool tls = false;
  void *ssl_ctx = nullptr;        // shared SSL_CTX (server + client roles)
  int wake_pipe[2] = {-1, -1};    // poke the poll loop on shutdown/connect
  std::thread loop;
  bool running = false;

  std::mutex mu;                               // guards conns + peer_addr
  std::vector<std::shared_ptr<Conn>> conns;
  std::map<int, std::shared_ptr<Conn>> by_peer;
  std::map<int, std::pair<std::string, int>> peer_addr;
  std::map<int, sockaddr_in> peer_sa;          // UDP: resolved at add_peer

  // per-peer send PAUSE (overload hardening, the native mirror of
  // runtime/transport.py's Python-surface pause — the pump's
  // rt_pump_flush sends land HERE, so without it a dead peer is
  // re-dialed on every round flush): after `pause_after` consecutive
  // send_msg failures to one peer, sends to it drop-with-count for
  // `pause_ms` instead of dialing.  A successful dial (send path OR the
  // reconnect loop's rt_node_connect) clears the pause.  Guarded by mu;
  // the counters are atomics so the Python drain path can fold them
  // into wire.peer_pauses / wire.backpressure_drops lock-free.
  int pause_after = 16;
  int pause_ms = 250;
  std::map<int, int> send_fails;
  std::map<int, std::chrono::steady_clock::time_point> send_pause;
  std::atomic<uint64_t> send_pauses{0};
  std::atomic<uint64_t> send_pause_drops{0};

  std::mutex inbox_mu;
  std::condition_variable inbox_cv;
  std::deque<Msg> inbox;
  size_t max_inbox = 1 << 16;     // drop + count when full (bufferSize
  size_t dropped = 0;             // semantics, InstanceHandler.scala:85-90)
  // BOUNDED inbox bytes + backpressure watermarks (overload hardening,
  // docs/HOST_FAULT_MODEL.md): the message-count cap alone let 65536
  // near-64 MiB frames queue ~4 TiB — the byte cap makes the inbox a
  // fixed-memory structure (drop + count beyond it, like the count cap),
  // and the high/low watermarks raise a BACKPRESSURE signal the drivers
  // drain on (kReadyBackpr reason bit / rt_node_backpressure) well
  // before anything is dropped.
  size_t inbox_bytes = 0;                       // guarded by inbox_mu
  size_t max_inbox_bytes = 256ull << 20;        // hard drop cap
  size_t bp_high = 32ull << 20;                 // raise backpressure
  size_t bp_low = 8ull << 20;                   // clear backpressure
  std::atomic<bool> backpressure{false};
  std::atomic<uint64_t> bp_edges{0};            // rising-edge counter
  static constexpr uint32_t kMaxFrame = 64u << 20;  // sane frame-size cap:
                                  // a larger claimed len closes the
                                  // connection (protocol violation)
  bool recv_stopped = false;      // recv returns -3 once stopped, so
                                  // blocked receiver threads can unwind
                                  // BEFORE the node is destroyed

  // round pump: allocated once at first rt_pump_enable, torn down only in
  // ~Node (the event loop reads `pump_on` without the node lock, so the
  // object must outlive any loop iteration that observed it enabled)
  Pump *pump = nullptr;
  std::atomic<bool> pump_on{false};

  ~Node() {
    stop();
    delete pump;
    if (ssl_ctx) tls_api().SSL_CTX_free(ssl_ctx);
  }

  void stop() {
    {
      std::lock_guard<std::mutex> l(mu);
      if (!running) return;
      running = false;
    }
    {
      std::lock_guard<std::mutex> l(inbox_mu);
      recv_stopped = true;
    }
    inbox_cv.notify_all();
    if (pump) {
      pump->stopped.store(true);
      pump->cv.notify_all();  // blocked rt_pump_wait callers unwind
    }
    if (wake_pipe[1] >= 0) { uint8_t b = 0; (void)!write(wake_pipe[1], &b, 1); }
    if (loop.joinable()) loop.join();
    // close each fd under ITS write mutex without holding `mu` (senders
    // take wmu then possibly mu, so mu->wmu nesting here could deadlock)
    std::vector<std::shared_ptr<Conn>> snapshot;
    {
      std::lock_guard<std::mutex> l(mu);
      snapshot = conns;
    }
    for (auto &c : snapshot) {
      std::lock_guard<std::mutex> lw(c->wmu);
      if (c->fd >= 0) { close(c->fd); c->fd = -1; }
    }
    std::lock_guard<std::mutex> l(mu);
    conns.clear(); by_peer.clear();
    if (listen_fd >= 0) { close(listen_fd); listen_fd = -1; }
    for (int i = 0; i < 2; ++i)
      if (wake_pipe[i] >= 0) { close(wake_pipe[i]); wake_pipe[i] = -1; }
    inbox_cv.notify_all();
  }

  // caller holds inbox_mu: account one popped message and clear the
  // backpressure flag once the drain reaches the low watermark
  void note_popped_locked(size_t nbytes) {
    inbox_bytes -= nbytes;
    if (backpressure.load(std::memory_order_relaxed) &&
        inbox_bytes <= bp_low)
      backpressure.store(false, std::memory_order_release);
  }

  void enqueue(Msg &&m) {
    {
      std::lock_guard<std::mutex> l(inbox_mu);
      if (inbox.size() >= max_inbox ||
          inbox_bytes + m.payload.size() > max_inbox_bytes) {
        ++dropped;
        return;
      }
      inbox_bytes += m.payload.size();
      inbox.push_back(std::move(m));
      if (!backpressure.load(std::memory_order_relaxed) &&
          inbox_bytes >= bp_high) {
        // rising edge: flag it (rt_node_backpressure level) and count it
        // (bp_edges — rt_pump_wait translates unseen edges into the
        // kReadyBackpr reason bit on armed lanes).  The pump mutex is
        // NOT taken here: deliver() already holds it when it calls
        // enqueue, and the misc notify below wakes any waiter anyway.
        backpressure.store(true, std::memory_order_release);
        bp_edges.fetch_add(1, std::memory_order_release);
      }
    }
    inbox_cv.notify_one();
    if (pump_on.load(std::memory_order_acquire)) {
      // misc traffic (decisions, foreign instances, template-miss
      // fallbacks) must interrupt a blocked rt_pump_wait: the Python side
      // drains the inbox on the misc flag
      pump->misc.store(true);
      pump->cv.notify_all();
    }
  }

  // frame delivery: the pump fast path when enabled (FLAG_BATCH containers
  // split HERE so sub-frames route without a Python wakeup), the plain
  // inbox otherwise.  Runs on the event-loop thread.  pump_on is
  // RE-CHECKED under the pump mutex: rt_pump_disable clears the flag and
  // then takes/releases that mutex, so once disable returns no event-loop
  // write can touch the Python-owned mailbox buffers (they are about to
  // be freed) — without the re-check a thread that loaded pump_on just
  // before the clear could still memcpy into freed memory.
  void deliver(int from, uint64_t tag, const uint8_t *p, size_t len) {
    if (pump_on.load(std::memory_order_acquire)) {
      std::unique_lock<std::mutex> l(pump->mu);
      if (pump_on.load(std::memory_order_relaxed)) {
        if ((tag & 0xFF) == kFlagBatch) {
          // sub-frame header: u64 tag | u32 len, little-endian
          // (runtime/transport.py _BATCH_HDR) — memcpy is exact on
          // x86-64
          ++pump->stats[kStBatchSplit];
          size_t off = 0;
          while (off + 12 <= len) {
            uint64_t sub;
            uint32_t l2;
            std::memcpy(&sub, p + off, 8);
            std::memcpy(&l2, p + off + 8, 4);
            off += 12;
            if (off + l2 > len) {
              ++pump->stats[kStBatchMalformed];
              return;  // truncated container: keep the parseable prefix
            }
            deliver_one_locked(from, sub, p + off, l2);
            off += l2;
          }
          if (off != len) ++pump->stats[kStBatchMalformed];
          return;
        }
        deliver_one_locked(from, tag, p, len);
        return;
      }
      // disabled while we waited for the mutex: fall through to the inbox
    }
    Msg m;
    m.from = from;
    m.tag = tag;
    m.payload.assign(p, p + len);
    enqueue(std::move(m));
  }

  // caller holds pump->mu
  void deliver_one_locked(int from, uint64_t tag, const uint8_t *p,
                          size_t len) {
    int rc = pump->route_locked(from, tag, p, len);
    if (rc == 1) return;
    if (rc == -2) ++pump->stats[kStFallback];  // wire-path template miss
    // non-NORMAL / unknown instance / template miss: the bilingual
    // Python path owns it (enqueue sets the misc wake)
    Msg m;
    m.from = from;
    m.tag = tag;
    m.payload.assign(p, p + len);
    enqueue(std::move(m));
  }

  // parse as many complete frames as rbuf holds; false = protocol
  // violation, the caller must close the connection
  bool drain(Conn &c) {
    size_t off = 0;
    bool ok = true;
    for (;;) {
      if (!c.handshaked) {
        if (c.rbuf.size() - off < 8) break;
        int peer = static_cast<int>(get_u32(c.rbuf.data() + off));
        uint32_t lport = get_u32(c.rbuf.data() + off + 4);
        if (lport == 0 || lport > 65535) { ok = false; break; }
        c.peer = peer;
        c.handshaked = true;
        off += 8;
        std::lock_guard<std::mutex> l(mu);
        auto ad = peer_addr.find(peer);
        if (ad != peer_addr.end() &&
            ad->second.second != static_cast<int>(lport)) {
          // the dialer claims an id our peer table assigns to a DIFFERENT
          // address: a stale replica from before a rename/remove (see the
          // handshake comment at the top) — close, do NOT install it as
          // the id's channel.  A peer we have no address for is accepted
          // as before (asymmetric add_peer deployments).
          ok = false;
          break;
        }
        by_peer[c.peer] = nullptr;  // placeholder; fixed below under lock
        for (auto &sp : conns)
          if (sp.get() == &c) by_peer[c.peer] = sp;
        continue;
      }
      if (c.rbuf.size() - off < 4) break;
      uint32_t len = get_u32(c.rbuf.data() + off);
      // cap the claimed frame size: the listen port is unauthenticated,
      // and an unbounded len would buffer rbuf without limit (advisor r02,
      // medium)
      if (len > kMaxFrame) { ok = false; break; }
      // size_t-widen before the addition: `4 + len` in 32-bit wraps for
      // len >= 0xFFFFFFFC and would pass this check while the 64-bit
      // iterator math below overruns rbuf (advisor r02, medium)
      if (c.rbuf.size() - off < 4 + static_cast<size_t>(len)) break;
      if (len < 8) { off += 4 + len; continue; }  // malformed: skip frame
      deliver(c.peer, get_u64(c.rbuf.data() + off + 4),
              c.rbuf.data() + off + 12, len - 8);
      off += 4 + len;
    }
    if (off > 0) c.rbuf.erase(c.rbuf.begin(), c.rbuf.begin() + off);
    return ok;
  }

  // UDP event loop: one socket, datagram = whole message
  void udp_loop_body() {
    std::vector<uint8_t> tmp(1 << 16);
    while (true) {
      pollfd pfds[2] = {{listen_fd, POLLIN, 0}, {wake_pipe[0], POLLIN, 0}};
      {
        std::lock_guard<std::mutex> l(mu);
        if (!running) return;
      }
      int rc = poll(pfds, 2, 200);
      if (rc < 0 && errno != EINTR) return;
      {
        std::lock_guard<std::mutex> l(mu);
        if (!running) return;
      }
      if (rc <= 0) continue;
      if (pfds[1].revents & POLLIN) {
        uint8_t b;
        while (read(wake_pipe[0], &b, 1) > 0) {}
      }
      if (!(pfds[0].revents & POLLIN)) continue;
      for (;;) {  // drain every queued datagram before re-polling
        ssize_t got = recvfrom(listen_fd, tmp.data(), tmp.size(),
                               MSG_DONTWAIT, nullptr, nullptr);
        if (got < 0) break;
        if (got < 12) continue;  // malformed datagram: drop
        deliver(static_cast<int>(get_u32(tmp.data())),
                get_u64(tmp.data() + 4), tmp.data() + 12,
                static_cast<size_t>(got) - 12);
      }
    }
  }

  bool udp_send(int peer, uint64_t tag, const uint8_t *payload, int len) {
    // one datagram per message; 12-byte header, kernel caps the rest
    if (len < 0 || len > 65507 - 12) return false;
    std::vector<uint8_t> pkt;
    pkt.reserve(12 + len);
    put_u32(pkt, static_cast<uint32_t>(id));
    put_u32(pkt, static_cast<uint32_t>(tag >> 32));
    put_u32(pkt, static_cast<uint32_t>(tag & 0xFFFFFFFFu));
    pkt.insert(pkt.end(), payload, payload + len);
    // sendto under `mu`: excludes stop() closing (and the fd number being
    // reused) mid-send — the UDP analogue of the TCP per-connection write
    // mutex.  The address was resolved once at add_peer, and MSG_DONTWAIT
    // keeps a full send buffer a DROP (UDP semantics), so the critical
    // section is short and never blocks the event loop.
    std::lock_guard<std::mutex> l(mu);
    auto sa = peer_sa.find(peer);
    if (sa == peer_sa.end() || listen_fd < 0) return false;
    ssize_t sent = sendto(
        listen_fd, pkt.data(), pkt.size(), MSG_DONTWAIT,
        reinterpret_cast<sockaddr *>(&sa->second), sizeof(sa->second));
    return sent == static_cast<ssize_t>(pkt.size()) ||
           (sent < 0 && (errno == EAGAIN || errno == EWOULDBLOCK ||
                         errno == ECONNREFUSED));
  }

  void loop_body() {
    if (udp) return udp_loop_body();
    std::vector<uint8_t> tmp(1 << 16);
    while (true) {
      std::vector<pollfd> pfds;
      std::vector<std::shared_ptr<Conn>> snapshot;
      {
        std::lock_guard<std::mutex> l(mu);
        if (!running) return;
        pfds.push_back({listen_fd, POLLIN, 0});
        pfds.push_back({wake_pipe[0], POLLIN, 0});
        for (auto &c : conns)
          if (c->fd >= 0) {
            pfds.push_back({c->fd, POLLIN, 0});
            snapshot.push_back(c);
          }
      }
      int rc = poll(pfds.data(), pfds.size(), 200);
      if (rc < 0 && errno != EINTR) return;
      {
        std::lock_guard<std::mutex> l(mu);
        if (!running) return;
      }
      if (rc <= 0) continue;
      if (pfds[1].revents & POLLIN) {
        uint8_t b;
        while (read(wake_pipe[0], &b, 1) > 0) {}
      }
      if (pfds[0].revents & POLLIN) {
        int fd = accept(listen_fd, nullptr, nullptr);
        if (fd >= 0) {
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          auto c = std::make_shared<Conn>();
          c->fd = fd;
          if (tls) {
            // nonblocking + server-side SSL; the handshake completes
            // inside the SSL_read calls of the read path
            fcntl(fd, F_SETFL, O_NONBLOCK);
            const TlsApi &api = tls_api();
            c->ssl = api.SSL_new(ssl_ctx);
            if (!c->ssl) { close(fd); continue; }
            api.SSL_set_fd(c->ssl, fd);
            api.SSL_set_accept_state(c->ssl);
          }
          std::lock_guard<std::mutex> l(mu);
          conns.push_back(c);
        }
      }
      for (size_t k = 0; k < snapshot.size(); ++k) {
        if (!(pfds[2 + k].revents & (POLLIN | POLLHUP | POLLERR))) continue;
        auto &c = snapshot[k];
        bool healthy = true;
        if (tls) {
          // drain every decrypted byte available now; WANT_READ = done.
          // try_lock: a sender thread may hold smu for seconds inside
          // ssl_write_all (slow peer) — blocking here would stall reads
          // for EVERY connection; skipping leaves the bytes queued in the
          // kernel and POLLIN re-fires on the next loop iteration
          const TlsApi &api = tls_api();
          std::unique_lock<std::mutex> ls(c->smu, std::try_to_lock);
          if (!ls.owns_lock()) continue;
          for (;;) {
            int got = api.SSL_read(c->ssl, tmp.data(),
                                   static_cast<int>(tmp.size()));
            if (got > 0) {
              c->rbuf.insert(c->rbuf.end(), tmp.data(), tmp.data() + got);
              continue;
            }
            int err = api.SSL_get_error(c->ssl, got);
            if (err == kSslErrorWantRead || err == kSslErrorWantWrite) break;
            healthy = false;  // clean shutdown, EOF, or protocol error
            break;
          }
          if (healthy) healthy = drain(*c);
        } else {
          ssize_t got = recv(c->fd, tmp.data(), tmp.size(), 0);
          healthy = got > 0;
          if (healthy) {
            c->rbuf.insert(c->rbuf.end(), tmp.data(), tmp.data() + got);
            healthy = drain(*c);  // false: frame-size protocol violation
          }
        }
        if (!healthy) {
          {
            // exclude senders mid-write before closing: otherwise the fd
            // number can be reused by a new accept and write_all would
            // send a frame down the wrong socket
            std::lock_guard<std::mutex> lw(c->wmu);
            close(c->fd);
            c->fd = -1;
          }
          std::lock_guard<std::mutex> l(mu);
          if (c->handshaked) {
            auto it = by_peer.find(c->peer);
            if (it != by_peer.end() && it->second == c) by_peer.erase(it);
          }
          continue;
        }
      }
      // compact closed connections
      std::lock_guard<std::mutex> l(mu);
      conns.erase(
          std::remove_if(conns.begin(), conns.end(),
                         [](const std::shared_ptr<Conn> &c) {
                           return c->fd < 0;
                         }),
          conns.end());
    }
  }

  std::shared_ptr<Conn> connect_to(int peer, int timeout_ms = 10'000) {
    std::pair<std::string, int> addr;
    int my_id;
    {
      std::lock_guard<std::mutex> l(mu);
      auto it = by_peer.find(peer);
      if (it != by_peer.end() && it->second && it->second->fd >= 0)
        return it->second;
      auto ad = peer_addr.find(peer);
      if (ad == peer_addr.end()) return nullptr;
      addr = ad->second;
      my_id = id;  // snapshot under mu: rt_node_set_id may rename us
    }
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    std::string port = std::to_string(addr.second);
    if (getaddrinfo(addr.first.c_str(), port.c_str(), &hints, &res) != 0)
      return nullptr;
    int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    // nonblocking connect bounded by timeout_ms: a blocking connect(2) to
    // an unreachable host stalls in SYN retries for seconds — the
    // reconnect loop (rt_node_connect callers) must never hang the caller
    // on a peer that is simply still dead
    bool ok = fd >= 0;
    if (ok) {
      fcntl(fd, F_SETFL, O_NONBLOCK);
      int rc = ::connect(fd, res->ai_addr, res->ai_addrlen);
      if (rc != 0 && errno == EINPROGRESS) {
        pollfd pfd{fd, POLLOUT, 0};
        ok = poll(&pfd, 1, timeout_ms) > 0;
        if (ok) {
          int err = 0;
          socklen_t elen = sizeof(err);
          ok = getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) == 0 &&
               err == 0;
        }
      } else {
        ok = rc == 0;
      }
    }
    if (ok) {
      // LOCALHOST SELF-CONNECT guard: dialing a not-yet-listening port
      // on 127.0.0.1 can land a TCP *simultaneous open* when the kernel
      // assigns our ephemeral source port equal to the destination port
      // — the socket connects to ITSELF, the handshake below echoes
      // back, and the "channel" is cached as live while the real peer
      // stays unreachable forever (observed: a fleet router dialing
      // shard replicas during their ~5 s interpreter startup wedged a
      // whole shard).  getsockname == getpeername is the signature.
      sockaddr_in self{}, peer_sa{};
      socklen_t slen = sizeof(self), plen = sizeof(peer_sa);
      if (getsockname(fd, reinterpret_cast<sockaddr *>(&self),
                      &slen) == 0 &&
          getpeername(fd, reinterpret_cast<sockaddr *>(&peer_sa),
                      &plen) == 0 &&
          self.sin_port == peer_sa.sin_port &&
          self.sin_addr.s_addr == peer_sa.sin_addr.s_addr)
        ok = false;
    }
    freeaddrinfo(res);
    if (!ok) {
      if (fd >= 0) close(fd);
      return nullptr;
    }
    if (!tls) {
      // restore blocking mode: write_all treats EAGAIN as a dead socket
      // (TLS conns stay nonblocking — ssl_write_all handles WANT_*)
      fcntl(fd, F_SETFL, fcntl(fd, F_GETFL) & ~O_NONBLOCK);
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    auto c = std::make_shared<Conn>();
    c->fd = fd;
    c->peer = peer;
    c->handshaked = true;  // outbound: we know who we dialed
    // handshake: our id + listen port first (TcpRuntime.scala:357-368's
    // client hello); in TLS mode the hello travels INSIDE the channel
    // (the first ssl_write_all also drives the TLS handshake, client
    // role)
    std::vector<uint8_t> hello;
    put_u32(hello, static_cast<uint32_t>(my_id));
    put_u32(hello, static_cast<uint32_t>(listen_port));
    bool sent;
    if (tls) {
      const TlsApi &api = tls_api();
      c->ssl = api.SSL_new(ssl_ctx);
      if (!c->ssl) { close(fd); return nullptr; }
      api.SSL_set_fd(c->ssl, fd);
      api.SSL_set_connect_state(c->ssl);
      std::lock_guard<std::mutex> ls(c->smu);
      sent = ssl_write_all(*c, hello.data(), hello.size(), 10'000);
    } else {
      sent = write_all(fd, hello.data(), hello.size());
    }
    if (!sent) {
      close(fd);
      c->fd = -1;
      return nullptr;
    }
    {
      std::lock_guard<std::mutex> l(mu);
      conns.push_back(c);
      by_peer[peer] = c;
      // a successful dial proves the peer is back: clear its send pause
      // (covers both the send path and the reconnect loop's probes)
      send_fails.erase(peer);
      send_pause.erase(peer);
    }
    if (wake_pipe[1] >= 0) { uint8_t b = 0; (void)!write(wake_pipe[1], &b, 1); }
    return c;
  }

  // Sever the live connection to `peer` (if any) without touching its
  // address entry: shutdown(2) from this thread, the event loop reaps the
  // fd on its next read error (the same no-close-outside-the-loop
  // discipline as the send failure path — closing here could hand the fd
  // number to a concurrent accept while the loop still polls it).
  void drop_conn(int peer) {
    std::shared_ptr<Conn> c;
    {
      std::lock_guard<std::mutex> l(mu);
      auto it = by_peer.find(peer);
      if (it == by_peer.end() || !it->second) return;
      c = it->second;
      by_peer.erase(it);
    }
    std::lock_guard<std::mutex> lw(c->wmu);
    if (c->fd >= 0) shutdown(c->fd, SHUT_RDWR);
    if (wake_pipe[1] >= 0) { uint8_t b = 0; (void)!write(wake_pipe[1], &b, 1); }
  }

  // Consecutive-failure bookkeeping for the send pause; mu must be held.
  void note_send_fail_locked(int peer) {
    int f = ++send_fails[peer];
    if (f >= pause_after && !send_pause.count(peer)) {
      send_pause[peer] = std::chrono::steady_clock::now() +
                         std::chrono::milliseconds(pause_ms);
      send_pauses.fetch_add(1, std::memory_order_relaxed);
    }
  }

  bool send_msg(int peer, uint64_t tag, const uint8_t *payload, int len) {
    if (udp) return udp_send(peer, tag, payload, len);
    // mirror the receiver's frame cap: an oversized frame would report
    // send success while the peer severs the link as a protocol violation
    if (len < 0 || static_cast<uint32_t>(len) > kMaxFrame - 8) return false;
    {
      // paused peer: drop-with-count instead of dialing (bounded-memory
      // discipline — the reconnect loop keeps probing in the background)
      std::lock_guard<std::mutex> lp(mu);
      auto it = send_pause.find(peer);
      if (it != send_pause.end()) {
        if (std::chrono::steady_clock::now() < it->second) {
          send_pause_drops.fetch_add(1, std::memory_order_relaxed);
          return false;
        }
        send_pause.erase(it);
        // probe posture past expiry: ONE failed dial re-engages the
        // pause (resetting to zero would put the flush back on the
        // dial treadmill for a full pause_after streak per window); a
        // success still clears the count entirely
        send_fails[peer] = pause_after - 1;
      }
    }
    // the send path is the round hot path (one rt_pump_flush per wave):
    // bound the dial far below connect_to's reconnect-loop default so a
    // black-holed peer (SYNs dropped, no RST) cannot stall a flush for
    // seconds — the failed dial feeds the pause, so the steady-state
    // cost of a dead peer is one bounded dial per pause window
    auto c = connect_to(peer, /*timeout_ms=*/250);
    if (!c) {
      std::lock_guard<std::mutex> lp(mu);
      note_send_fail_locked(peer);
      return false;
    }
    std::vector<uint8_t> frame;
    frame.reserve(12 + len);
    put_u32(frame, static_cast<uint32_t>(8 + len));
    put_u32(frame, static_cast<uint32_t>(tag >> 32));
    put_u32(frame, static_cast<uint32_t>(tag & 0xFFFFFFFFu));
    frame.insert(frame.end(), payload, payload + len);
    std::lock_guard<std::mutex> l(c->wmu);
    if (c->fd < 0) {
      std::lock_guard<std::mutex> l2(mu);
      note_send_fail_locked(peer);
      return false;
    }
    bool wrote;
    if (tls) {
      std::lock_guard<std::mutex> ls(c->smu);
      wrote = c->fd >= 0 &&
              ssl_write_all(*c, frame.data(), frame.size(), 10'000);
    } else {
      wrote = write_all(c->fd, frame.data(), frame.size());
    }
    if (!wrote) {
      // connection died mid-write: drop it, caller may retry (reconnect
      // semantics of TcpRuntime.scala:162-211).  TLS write DEADLINES leave
      // a live socket behind (the peer is slow, not gone) with a
      // half-written frame — no read error will ever reap it.  shutdown()
      // (NOT close) from this sender thread: the event loop may hold the
      // fd in an in-flight poll snapshot, and closing here would let the
      // fd number be reused by a concurrent connect while the loop still
      // reads the old SSL object through it.  shutdown makes the loop's
      // next SSL_read fail, and the REAPER (loop thread) does the close.
      if (tls && c->fd >= 0) shutdown(c->fd, SHUT_RDWR);
      std::lock_guard<std::mutex> l2(mu);
      auto it = by_peer.find(peer);
      if (it != by_peer.end() && it->second == c) by_peer.erase(it);
      note_send_fail_locked(peer);
      return false;
    }
    {
      std::lock_guard<std::mutex> l2(mu);
      send_fails.erase(peer);
    }
    return true;
  }
};

}  // namespace

extern "C" {

static void *node_create(int id, int listen_port, bool udp,
                         void *tls_ctx = nullptr) {
  auto *n = new Node();
  n->id = id;
  n->udp = udp;
  n->tls = tls_ctx != nullptr;   // before the loop thread starts: an early
  n->ssl_ctx = tls_ctx;          // accept must already take the TLS path
  n->listen_fd = socket(AF_INET, udp ? SOCK_DGRAM : SOCK_STREAM, 0);
  if (n->listen_fd < 0) { delete n; return nullptr; }
  int one = 1;
  setsockopt(n->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_addr.s_addr = htonl(INADDR_ANY);
  sa.sin_port = htons(static_cast<uint16_t>(listen_port));
  if (bind(n->listen_fd, reinterpret_cast<sockaddr *>(&sa), sizeof(sa)) != 0 ||
      (!udp && listen(n->listen_fd, 64) != 0) || pipe(n->wake_pipe) != 0) {
    close(n->listen_fd);
    delete n;
    return nullptr;
  }
  // the wake pipe is drained with a read loop: it MUST be non-blocking or
  // the drain blocks the event loop once empty
  fcntl(n->wake_pipe[0], F_SETFL, O_NONBLOCK);
  fcntl(n->wake_pipe[1], F_SETFL, O_NONBLOCK);
  {
    // resolve the bound port once (listen_port==0 binds ephemeral); it is
    // advertised in every outbound hello as this node's wire identity
    sockaddr_in bound{};
    socklen_t blen = sizeof(bound);
    if (getsockname(n->listen_fd, reinterpret_cast<sockaddr *>(&bound),
                    &blen) == 0)
      n->listen_port = ntohs(bound.sin_port);
  }
  n->running = true;
  n->loop = std::thread([n] { n->loop_body(); });
  return n;
}

void *rt_node_create(int id, int listen_port) {
  return node_create(id, listen_port, false);
}

// The reference's default perf transport shape (UdpRuntime.scala:19-96):
// datagram socket, drop-tolerant, one packet per message.
void *rt_node_create_udp(int id, int listen_port) {
  return node_create(id, listen_port, true);
}

// TCP_SSL (TcpRuntime.scala:143-158): the framed protocol inside TLS.
// cert/key are PEM paths (the Python layer generates a self-signed pair
// when the caller supplies none).  Returns nullptr when libssl is
// unavailable or the certificate does not load.
void *rt_node_create_tls(int id, int listen_port, const char *cert_pem,
                         const char *key_pem) {
  const TlsApi &api = tls_api();
  if (!api.ok) return nullptr;
  void *ctx = api.SSL_CTX_new(api.TLS_method());
  if (!ctx) return nullptr;
  if (api.SSL_CTX_use_certificate_chain_file(ctx, cert_pem) != 1 ||
      api.SSL_CTX_use_PrivateKey_file(ctx, key_pem, kSslFiletypePem) != 1) {
    api.SSL_CTX_free(ctx);
    return nullptr;
  }
  // on failure node_create already deleted the Node, whose destructor
  // freed ctx — freeing it here again would be a double free
  return node_create(id, listen_port, false, ctx);
}

int rt_node_port(void *node) {
  auto *n = static_cast<Node *>(node);
  sockaddr_in sa{};
  socklen_t len = sizeof(sa);
  if (getsockname(n->listen_fd, reinterpret_cast<sockaddr *>(&sa), &len) != 0)
    return -1;
  return ntohs(sa.sin_port);
}

void rt_node_add_peer(void *node, int peer_id, const char *host, int port) {
  auto *n = static_cast<Node *>(node);
  sockaddr_in sa{};
  bool have_sa = false;
  if (n->udp) {
    // resolve ONCE here, not per datagram (the send path is hot and must
    // not do synchronous DNS); resolution happens outside the node lock
    sa.sin_family = AF_INET;
    sa.sin_port = htons(static_cast<uint16_t>(port));
    if (inet_pton(AF_INET, host, &sa.sin_addr) == 1) {
      have_sa = true;
    } else {
      addrinfo hints{}, *res = nullptr;
      hints.ai_family = AF_INET;
      hints.ai_socktype = SOCK_DGRAM;
      if (getaddrinfo(host, nullptr, &hints, &res) == 0) {
        sa.sin_addr = reinterpret_cast<sockaddr_in *>(res->ai_addr)->sin_addr;
        freeaddrinfo(res);
        have_sa = true;
      }
    }
  }
  std::lock_guard<std::mutex> l(n->mu);
  n->peer_addr[peer_id] = {host, port};
  if (have_sa) n->peer_sa[peer_id] = sa;
}

// Forget a peer: sever its live connection and drop its address entry.
// Sends to it fail from now on; the listen socket still ACCEPTS from it
// (the unauthenticated-socket trust model is unchanged — the epoch stamp
// in the Tag is what rejects a removed replica's traffic semantically).
void rt_node_remove_peer(void *node, int peer_id) {
  auto *n = static_cast<Node *>(node);
  if (!n->udp) n->drop_conn(peer_id);
  std::lock_guard<std::mutex> l(n->mu);
  n->peer_addr.erase(peer_id);
  n->peer_sa.erase(peer_id);
}

// Rename this node (Replicas.scala:136-142 renameReplica, the wire half):
// future outbound handshakes and UDP sender headers carry the new id.
// Peers holding connections handshaked under the OLD id keep attributing
// in-flight frames to it until those channels are dropped — which is why
// a view change that renames ids severs and re-dials the affected
// channels (runtime/transport.py rewire) and stamps traffic with the view
// epoch so stale attribution is detected, not trusted.
void rt_node_set_id(void *node, int new_id) {
  auto *n = static_cast<Node *>(node);
  std::lock_guard<std::mutex> l(n->mu);
  n->id = new_id;
}

// 1 when a live channel to `peer` exists (UDP: when its address is
// registered — datagram sockets have no connection state), else 0.
int rt_node_connected(void *node, int peer_id) {
  auto *n = static_cast<Node *>(node);
  std::lock_guard<std::mutex> l(n->mu);
  if (n->udp) return n->peer_sa.count(peer_id) ? 1 : 0;
  auto it = n->by_peer.find(peer_id);
  return (it != n->by_peer.end() && it->second && it->second->fd >= 0)
             ? 1 : 0;
}

// Dial `peer` now (bounded by timeout_ms) without sending anything:
// the reconnect-loop primitive (runtime/transport.py drives period +
// backoff).  0 = a channel exists (already or freshly connected),
// -1 = could not connect.  UDP nodes are always "connected".
int rt_node_connect(void *node, int peer_id, int timeout_ms) {
  auto *n = static_cast<Node *>(node);
  if (n->udp) {
    std::lock_guard<std::mutex> l(n->mu);
    return n->peer_sa.count(peer_id) ? 0 : -1;
  }
  return n->connect_to(peer_id, timeout_ms) ? 0 : -1;
}

int rt_node_send(void *node, int peer_id, uint64_t tag,
                 const uint8_t *payload, int len) {
  auto *n = static_cast<Node *>(node);
  return n->send_msg(peer_id, tag, payload, len) ? 0 : -1;
}

// Returns payload length (>= 0) with *from/*tag filled, -1 on timeout,
// -2 if buf is too small (message stays queued; call again bigger),
// -3 once the node was stopped (rt_node_stop) and the inbox is empty.
int rt_node_recv(void *node, int *from, uint64_t *tag, uint8_t *buf,
                 int buflen, int timeout_ms) {
  auto *n = static_cast<Node *>(node);
  std::unique_lock<std::mutex> l(n->inbox_mu);
  n->inbox_cv.wait_for(l, std::chrono::milliseconds(timeout_ms),
                       [n] { return !n->inbox.empty() || n->recv_stopped; });
  if (n->inbox.empty()) return n->recv_stopped ? -3 : -1;
  Msg &m = n->inbox.front();
  if (static_cast<int>(m.payload.size()) > buflen) return -2;
  *from = m.from;
  *tag = m.tag;
  std::memcpy(buf, m.payload.data(), m.payload.size());
  int len = static_cast<int>(m.payload.size());
  n->note_popped_locked(m.payload.size());
  n->inbox.pop_front();
  return len;
}

// Batched drain: pack EVERY queued message (up to buflen) into buf as
// consecutive records
//
//   i32 from | u64 tag | u32 len | payload[len]        (native endianness)
//
// waiting up to timeout_ms for the first one.  One ctypes call + one
// Python-side copy replaces a copy-out call per message — the hot-path
// receive of runtime/transport.py (messages stay queued when they don't
// fit, so a partial drain just means another call).  *nbytes gets the
// total bytes packed.  Returns the number of messages packed, 0 on
// timeout, -2 if the FIRST message cannot fit buflen (call again with a
// bigger buf), -3 once the node was stopped and the inbox is empty.
int rt_node_recv_many(void *node, uint8_t *buf, int buflen, int timeout_ms,
                      int *nbytes) {
  auto *n = static_cast<Node *>(node);
  *nbytes = 0;
  std::unique_lock<std::mutex> l(n->inbox_mu);
  n->inbox_cv.wait_for(l, std::chrono::milliseconds(timeout_ms),
                       [n] { return !n->inbox.empty() || n->recv_stopped; });
  if (n->inbox.empty()) return n->recv_stopped ? -3 : 0;
  constexpr size_t kHdr = sizeof(int32_t) + sizeof(uint64_t) +
                          sizeof(uint32_t);
  size_t off = 0;
  int count = 0;
  while (!n->inbox.empty()) {
    Msg &m = n->inbox.front();
    size_t need = kHdr + m.payload.size();
    if (off + need > static_cast<size_t>(buflen)) {
      if (count == 0) return -2;  // first message alone overflows the buf
      break;                      // the rest stays queued for the next call
    }
    int32_t from = m.from;
    uint64_t tag = m.tag;
    uint32_t len = static_cast<uint32_t>(m.payload.size());
    std::memcpy(buf + off, &from, sizeof(from));
    std::memcpy(buf + off + 4, &tag, sizeof(tag));
    std::memcpy(buf + off + 12, &len, sizeof(len));
    if (len) std::memcpy(buf + off + kHdr, m.payload.data(), len);
    off += need;
    ++count;
    n->note_popped_locked(m.payload.size());
    n->inbox.pop_front();
  }
  *nbytes = static_cast<int>(off);
  return count;
}

// Stop the node (event loop joined, sockets closed, blocked rt_node_recv
// calls return -3) WITHOUT freeing it: lets receiver threads unwind before
// rt_node_destroy.  Idempotent.
void rt_node_stop(void *node) {
  static_cast<Node *>(node)->stop();
}

uint64_t rt_node_dropped(void *node) {
  auto *n = static_cast<Node *>(node);
  std::lock_guard<std::mutex> l(n->inbox_mu);
  return n->dropped;
}

// 1 while the inbox sits above its byte high watermark (cleared once a
// drain reaches the low watermark) — the level form of the kReadyBackpr
// reason bit, for pump-less callers and harness assertions.
int rt_node_backpressure(void *node) {
  return static_cast<Node *>(node)->backpressure.load() ? 1 : 0;
}

unsigned long long rt_node_inbox_bytes(void *node) {
  auto *n = static_cast<Node *>(node);
  std::lock_guard<std::mutex> l(n->inbox_mu);
  return n->inbox_bytes;
}

// Configure the bounded-inbox caps and backpressure watermarks; any
// argument <= 0 keeps the current value.  Requires lo <= hi <= max_bytes
// (rejected with -1, the caps must stay a coherent ladder).
int rt_node_set_inbox_limits(void *node, long long max_msgs,
                             long long max_bytes, long long hi,
                             long long lo) {
  auto *n = static_cast<Node *>(node);
  std::lock_guard<std::mutex> l(n->inbox_mu);
  size_t mm = max_msgs > 0 ? static_cast<size_t>(max_msgs) : n->max_inbox;
  size_t mb = max_bytes > 0 ? static_cast<size_t>(max_bytes)
                            : n->max_inbox_bytes;
  size_t h = hi > 0 ? static_cast<size_t>(hi) : n->bp_high;
  size_t lw = lo > 0 ? static_cast<size_t>(lo) : n->bp_low;
  if (lw > h || h > mb) return -1;
  n->max_inbox = mm;
  n->max_inbox_bytes = mb;
  n->bp_high = h;
  n->bp_low = lw;
  // re-evaluate the level against the new ladder so a tightened
  // watermark takes effect without waiting for the next enqueue
  if (!n->backpressure.load() && n->inbox_bytes >= n->bp_high) {
    n->backpressure.store(true);
    n->bp_edges.fetch_add(1);
  } else if (n->backpressure.load() && n->inbox_bytes <= n->bp_low) {
    n->backpressure.store(false);
  }
  return 0;
}

// Per-peer send-pause counters: out[0] = pauses engaged, out[1] = frames
// dropped while paused.  The Python drain path diffs these into the
// shared wire.peer_pauses / wire.backpressure_drops counters so pump-path
// drops are accounted in the same vocabulary as Python-surface drops.
int rt_node_send_pause_stats(void *node, unsigned long long *out) {
  auto *n = static_cast<Node *>(node);
  out[0] = n->send_pauses.load(std::memory_order_relaxed);
  out[1] = n->send_pause_drops.load(std::memory_order_relaxed);
  return 0;
}

// Configure the native send pause (any argument <= 0 keeps the value).
int rt_node_set_send_pause(void *node, int after, int ms) {
  auto *n = static_cast<Node *>(node);
  std::lock_guard<std::mutex> l(n->mu);
  if (after > 0) n->pause_after = after;
  if (ms > 0) n->pause_ms = ms;
  return 0;
}

void rt_node_destroy(void *node) {
  auto *n = static_cast<Node *>(node);
  n->stop();
  delete n;
}

// ---------------------------------------------------------------------------
// round pump API (see the file-top comment).  All pointers passed here are
// Python-owned numpy buffers that MUST outlive the pump (the Python
// wrapper, runtime/transport.py RoundPump, pins them).
// ---------------------------------------------------------------------------

// Enable (or reconfigure) the pump: L lanes, n processes, k round classes,
// nbz byzantine tolerance for the catch-up rule.  max_rnd = int64[L*n],
// next_round = int64[L], stats = u64[16].  Reconfiguring drops all lane
// state; callers do it only between runs (no concurrent waiters).
int rt_pump_enable(void *node, int L, int n, int k, int nbz,
                   long long *max_rnd, long long *next_round,
                   unsigned long long *stats) {
  auto *nd = static_cast<Node *>(node);
  if (L <= 0 || n <= 0 || k <= 0 || nbz < 0 || nbz >= n) return -1;
  nd->pump_on.store(false, std::memory_order_release);
  if (!nd->pump) nd->pump = new Pump();
  nd->pump->configure(L, n, k, nbz, max_rnd, next_round, stats);
  {
    // frames that arrived BEFORE the pump existed are sitting in the
    // inbox with no misc flag: seed it, or the first armed round would
    // burn its whole deadline blind to them (observed: exactly one
    // burned deadline per replica in process mode, where peers start
    // seconds apart and the early ones' traffic predates the enable)
    std::lock_guard<std::mutex> l(nd->inbox_mu);
    if (!nd->inbox.empty()) nd->pump->misc.store(true);
  }
  nd->pump_on.store(true, std::memory_order_release);
  return 0;
}

// Disable the fast path: frames flow to the inbox again.  Lane state and
// registered buffers are retired (a later enable reconfigures).  The
// mutex acquisition after the clear FENCES in-flight deliveries: the
// event loop re-checks pump_on under the same mutex, so once this
// returns no native write can touch the (about to be freed) Python
// mailbox buffers.
void rt_pump_disable(void *node) {
  auto *nd = static_cast<Node *>(node);
  nd->pump_on.store(false, std::memory_order_release);
  if (nd->pump) {
    { std::lock_guard<std::mutex> l(nd->pump->mu); }
    nd->pump->cv.notify_all();
  }
}

// Register one (lane, class) slot: the payload TEMPLATE (tlen bytes, the
// codec encoding of the class's exemplar payload), its holes (packed
// u32 off | u32 len | u32 leaf, ascending), the leaf destinations (packed
// u64 base_ptr | u32 nbytes), and the lane's shared mask/count.  Returns
// 0, or -1 on a malformed registration (overlapping/oversized holes,
// hole/leaf size mismatch).
int rt_pump_set_class(void *node, int lane, int cls, const uint8_t *tmpl,
                      int tlen, const uint8_t *holes, int nholes,
                      const uint8_t *leaves, int nleaves, uint8_t *mask,
                      long long *count) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P) return -1;
  std::lock_guard<std::mutex> l(P->mu);
  if (lane < 0 || lane >= P->L || cls < 0 || cls >= P->k || tlen < 0)
    return -1;
  PumpSlot s;
  s.tmpl.assign(tmpl, tmpl + tlen);
  s.leaves.resize(nleaves);
  for (int i = 0; i < nleaves; ++i) {
    uint64_t base;
    uint32_t nb;
    std::memcpy(&base, leaves + i * 12, 8);
    std::memcpy(&nb, leaves + i * 12 + 8, 4);
    s.leaves[i].base = reinterpret_cast<uint8_t *>(base);
    s.leaves[i].nbytes = nb;
  }
  uint32_t prev_end = 0;
  s.holes.resize(nholes);
  for (int i = 0; i < nholes; ++i) {
    PumpHole h;
    std::memcpy(&h.off, holes + i * 12, 4);
    std::memcpy(&h.len, holes + i * 12 + 4, 4);
    std::memcpy(&h.leaf, holes + i * 12 + 8, 4);
    if (h.off < prev_end ||
        static_cast<uint64_t>(h.off) + h.len > static_cast<uint64_t>(tlen) ||
        h.leaf >= static_cast<uint32_t>(nleaves) ||
        h.len != s.leaves[h.leaf].nbytes)
      return -1;
    prev_end = h.off + h.len;
    s.holes[i] = h;
  }
  s.mask = mask;
  s.count = count;
  P->lanes[lane].slots[cls] = std::move(s);
  return 0;
}

// Map instance id -> lane.  Python resets the shared max_rnd/next_round
// rows BEFORE opening; pending/ready state is cleared here.
int rt_pump_open_lane(void *node, int lane, int iid) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P) return -1;
  std::lock_guard<std::mutex> l(P->mu);
  if (lane < 0 || lane >= P->L || iid < 0 || iid >= (1 << 16)) return -1;
  PumpLane &ln = P->lanes[lane];
  if (ln.iid >= 0 && P->iid2lane[ln.iid] == lane) P->iid2lane[ln.iid] = -1;
  ln.iid = iid;
  ln.open_ = true;
  ln.armed = false;
  ln.round_ = 0;
  ln.ready = 0;
  ln.has_deadline = false;
  ln.pending.clear();
  ln.pending_frames = 0;
  P->iid2lane[iid] = lane;
  return 0;
}

// Retire the lane: its instance's frames flow to the inbox again (the
// TooLate decision-reply path in Python).
void rt_pump_close_lane(void *node, int lane) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P) return;
  std::lock_guard<std::mutex> l(P->mu);
  if (lane < 0 || lane >= P->L) return;
  PumpLane &ln = P->lanes[lane];
  if (ln.iid >= 0 && P->iid2lane[ln.iid] == lane) P->iid2lane[ln.iid] = -1;
  ln.iid = -1;
  ln.open_ = false;
  ln.armed = false;
  ln.ready = 0;
  ln.has_deadline = false;
  ln.pending.clear();
  ln.pending_frames = 0;
}

namespace {

// caller holds P->mu.  The arm transition: adopt the round, apply the
// natively-buffered pending frames (full template check — a mismatch goes
// to the inbox for the bilingual Python path), then evaluate readiness.
void pump_arm_locked(Node *nd, Pump *P, int lane, long long round, int cls,
                     long long threshold, uint32_t flags, int deadline_ms,
                     int extend_ms, uint8_t auto_disarm) {
  PumpLane &ln = P->lanes[lane];
  ln.round_ = round;
  ln.cls = cls;
  ln.threshold = threshold;
  ln.flags = flags;
  ln.auto_disarm = auto_disarm;
  ln.extend_ms = extend_ms;
  ln.ready = 0;
  ln.armed = true;
  if (deadline_ms > 0) {
    ln.deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(deadline_ms);
    ln.has_deadline = true;
  } else {
    ln.has_deadline = false;
  }
  // garbage-collect pending rounds the lane has moved past
  while (!ln.pending.empty() && ln.pending.begin()->first < round) {
    ln.pending_frames -= ln.pending.begin()->second.size();
    ln.pending.erase(ln.pending.begin());
  }
  auto it = ln.pending.find(round);
  if (it != ln.pending.end()) {
    for (auto &kv : it->second) {
      ++P->stats[kStApplied];
      int rc = P->slot_insert(ln.slots[cls], kv.first, kv.second.data(),
                              kv.second.size());
      if (rc == 1) {
        ++P->stats[kStFast];
      } else if (rc == 0) {
        ++P->stats[kStDup];
      } else {
        // legacy-pickle / structurally-alien payload: Python decodes it
        ++P->stats[kStFallback];
        Msg m;
        m.from = kv.first;
        m.tag = (static_cast<uint64_t>(round) << 32) |
                (static_cast<uint64_t>(ln.iid & 0xFFFF) << 16);
        m.payload = std::move(kv.second);
        nd->enqueue(std::move(m));
      }
    }
    ln.pending_frames -= it->second.size();
    ln.pending.erase(it);
  }
  uint8_t newly = 0;
  if (ln.threshold > 0 && ln.slots[cls].count &&
      *ln.slots[cls].count >= ln.threshold)
    newly |= kReadyThresh;
  if (!(flags & kPumpStrict) && P->next_round[lane] > round + 1)
    newly |= kReadySkew;
  if (newly) {
    ln.ready |= newly;
    P->cv.notify_all();
  }
}

}  // namespace

// Arm one lane for (round, cls).  Python has already reset the mailbox
// row, inserted self-delivery/prefill, and set count accordingly.
int rt_pump_arm(void *node, int lane, long long round, int cls,
                long long threshold, uint32_t flags, int deadline_ms,
                int extend_ms, uint8_t auto_disarm) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P) return -1;
  std::lock_guard<std::mutex> l(P->mu);
  if (lane < 0 || lane >= P->L || cls < 0 || cls >= P->k) return -1;
  pump_arm_locked(nd, P, lane, round, cls, threshold, flags, deadline_ms,
                  extend_ms, auto_disarm);
  return 0;
}

// Batched arm: one ctypes crossing per send WAVE (the lane driver arms up
// to L lanes per wave).  specs = packed records of
//   i32 lane | i32 round | i32 cls | i64 threshold | u32 flags |
//   i32 deadline_ms | i32 extend_ms | u8 auto_disarm        (33 bytes)
int rt_pump_arm_many(void *node, const uint8_t *specs, int count) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P) return -1;
  std::lock_guard<std::mutex> l(P->mu);
  for (int i = 0; i < count; ++i) {
    const uint8_t *p = specs + static_cast<size_t>(i) * 33;
    int32_t lane, round32, cls, dl, ext;
    int64_t thr;
    uint32_t flags;
    uint8_t ad;
    std::memcpy(&lane, p, 4);
    std::memcpy(&round32, p + 4, 4);
    std::memcpy(&cls, p + 8, 4);
    std::memcpy(&thr, p + 12, 8);
    std::memcpy(&flags, p + 20, 4);
    std::memcpy(&dl, p + 24, 4);
    std::memcpy(&ext, p + 28, 4);
    ad = p[32];
    if (lane < 0 || lane >= P->L || cls < 0 || cls >= P->k) return -1;
    pump_arm_locked(nd, P, lane, round32, cls, thr, flags, dl, ext, ad);
  }
  return 0;
}

// Disarm: after this returns, the event loop buffers the lane's frames as
// pending instead of writing its mailbox — Python may read/reset freely.
void rt_pump_disarm(void *node, int lane) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P) return;
  std::lock_guard<std::mutex> l(P->mu);
  if (lane < 0 || lane >= P->L) return;
  P->lanes[lane].armed = false;
  P->lanes[lane].ready = 0;
  P->lanes[lane].has_deadline = false;
}

// THE blocking wait: returns when >= 1 lane is ready (reasons_out[lane]
// gets the reason bits, which are consumed; auto_disarm reasons disarm
// atomically), when misc inbox traffic arrived (*misc_out = 1, flag
// consumed), on timeout (0 with *misc_out = 0), or -3 once the node
// stopped.  Lane deadlines are evaluated HERE against steady_clock — no
// Python-side polling tick exists in pump mode.
int rt_pump_wait(void *node, uint8_t *reasons_out, int timeout_ms,
                 int *misc_out) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  *misc_out = 0;
  if (!P) return -1;
  auto t_end = std::chrono::steady_clock::now() +
               std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms);
  std::unique_lock<std::mutex> l(P->mu);
  ++P->stats[kStWaits];
  for (;;) {
    if (P->stopped.load()) return -3;
    // inbox backpressure edge -> kReadyBackpr on every armed lane: the
    // waiter must drain the inbox NOW, not after a full deadline (the
    // bit is never in auto_disarm, so the round itself keeps running)
    uint64_t bpe = nd->bp_edges.load(std::memory_order_acquire);
    if (bpe != P->bp_seen) {
      P->bp_seen = bpe;
      for (int i = 0; i < P->L; ++i)
        if (P->lanes[i].armed) P->lanes[i].ready |= kReadyBackpr;
    }
    auto now = std::chrono::steady_clock::now();
    bool have_dl = false;
    std::chrono::steady_clock::time_point min_dl{};
    for (int i = 0; i < P->L; ++i) {
      PumpLane &ln = P->lanes[i];
      if (!ln.armed || !ln.has_deadline) continue;
      if (now >= ln.deadline) {
        ln.ready |= kReadyDeadline;
        ln.has_deadline = false;  // report an expiry exactly once
      } else if (!have_dl || ln.deadline < min_dl) {
        min_dl = ln.deadline;
        have_dl = true;
      }
    }
    int nready = 0;
    for (int i = 0; i < P->L; ++i)
      if (P->lanes[i].ready) ++nready;
    bool misc = P->misc.load();
    if (nready > 0 || misc) {
      for (int i = 0; i < P->L; ++i) {
        PumpLane &ln = P->lanes[i];
        reasons_out[i] = ln.ready;
        if (ln.ready) {
          if (ln.ready & ln.auto_disarm) {
            ln.armed = false;
            ln.has_deadline = false;
          }
          ln.ready = 0;
        }
      }
      if (misc) {
        P->misc.store(false);
        *misc_out = 1;
        ++P->stats[kStWakesMisc];
      }
      if (nready) ++P->stats[kStWakesReady];
      return nready;
    }
    if (now >= t_end) {
      std::memset(reasons_out, 0, P->L);
      return 0;
    }
    auto wake_t = t_end;
    if (have_dl && min_dl < wake_t) wake_t = min_dl;
    P->cv.wait_until(l, wake_t);
  }
}

// Single-lane wait (per-instance runners multiplexed over one transport):
// returns the lane's reason bits (consumed; auto_disarm honored), 0 on
// timeout, -3 once stopped.  Does NOT consume the misc flag — a router
// thread owns the inbox in that deployment and pokes lanes explicitly.
int rt_pump_wait_lane(void *node, int lane, int timeout_ms) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P || lane < 0 || lane >= P->L) return -1;
  auto t_end = std::chrono::steady_clock::now() +
               std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms);
  std::unique_lock<std::mutex> l(P->mu);
  PumpLane &ln = P->lanes[lane];
  for (;;) {
    if (P->stopped.load()) return -3;
    // backpressure edge: the FIRST lane waiter to observe it gets the
    // bit (draining the shared inbox is a global act — one drainer
    // suffices; in the mux deployment the router thread is the primary
    // drainer and this bit is advisory)
    uint64_t bpe = nd->bp_edges.load(std::memory_order_acquire);
    if (bpe != P->bp_seen) {
      P->bp_seen = bpe;
      if (ln.armed) ln.ready |= kReadyBackpr;
    }
    auto now = std::chrono::steady_clock::now();
    if (ln.armed && ln.has_deadline && now >= ln.deadline) {
      ln.ready |= kReadyDeadline;
      ln.has_deadline = false;
    }
    if (ln.ready) {
      int r = ln.ready;
      if (ln.ready & ln.auto_disarm) {
        ln.armed = false;
        ln.has_deadline = false;
      }
      ln.ready = 0;
      return r;
    }
    if (now >= t_end) return 0;
    auto wake_t = t_end;
    if (ln.armed && ln.has_deadline && ln.deadline < wake_t)
      wake_t = ln.deadline;
    P->cv.wait_until(l, wake_t);
  }
}

// Nudge one lane's waiter (kReadyPoke): the mux router thread queued
// out-of-band traffic for that lane's runner.
void rt_pump_poke(void *node, int lane) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P) return;
  std::lock_guard<std::mutex> l(P->mu);
  if (lane < 0 || lane >= P->L) return;
  P->lanes[lane].ready |= kReadyPoke;
  P->cv.notify_all();
}

// Feed one frame from Python (stash replay at admission, inbox-fallback
// re-routing): the same state machine as the wire path, but a template
// miss at the armed current round returns -2 instead of re-queuing to the
// inbox (the caller decodes and uses rt_pump_insert).  Returns 1 consumed,
// 0 not pump-routable, -2 template miss.
int rt_pump_feed(void *node, int from, uint64_t tag, const uint8_t *buf,
                 int len) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P) return 0;
  std::lock_guard<std::mutex> l(P->mu);
  return P->route_locked(from, tag, buf, len);
}

// Canonical insert under the pump lock (the Python fallback path after
// decoding a legacy/pickle payload and re-encoding it in slot dtypes):
// 1 = grew, 0 = duplicate overwrite, -1 = template mismatch (structurally
// alien payload — the caller marks the sender malformed).
int rt_pump_insert(void *node, int lane, int sender, const uint8_t *buf,
                   int len) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P) return -1;
  std::lock_guard<std::mutex> l(P->mu);
  if (lane < 0 || lane >= P->L || sender < 0 || sender >= P->n) return -1;
  PumpLane &ln = P->lanes[lane];
  int rc = P->slot_insert(ln.slots[ln.cls], sender, buf,
                          static_cast<size_t>(len));
  if (rc < 0) return -1;
  uint8_t newly = 0;
  if (rc == 1 && ln.armed) {
    ++P->stats[kStFast];
    if (ln.threshold > 0 && *ln.slots[ln.cls].count >= ln.threshold)
      newly |= kReadyThresh;
  } else if (rc == 0) {
    ++P->stats[kStDup];  // host.recvs parity: banked like wire dups
  }
  if (ln.armed && (ln.flags & kPumpGrowth)) newly |= kReadyGrowth;
  if (newly) {
    ln.ready |= newly;
    P->cv.notify_all();
  }
  return rc;
}

// Structural-garbage semantics of the Python mailboxes: clear the
// sender's heard bit, zero its slots (a half-written slot must not leak).
void rt_pump_mark_malformed(void *node, int lane, int sender) {
  auto *nd = static_cast<Node *>(node);
  Pump *P = nd->pump;
  if (!P) return;
  std::lock_guard<std::mutex> l(P->mu);
  if (lane < 0 || lane >= P->L || sender < 0 || sender >= P->n) return;
  PumpLane &ln = P->lanes[lane];
  PumpSlot &s = ln.slots[ln.cls];
  if (s.mask && s.mask[sender]) {
    s.mask[sender] = 0;
    --*s.count;
  }
  for (const auto &lf : s.leaves)
    std::memset(lf.base + static_cast<size_t>(sender) * lf.nbytes, 0,
                lf.nbytes);
}

// Ship one send WAVE in a single ctypes crossing: entries reference the
// encode-once scratch (base) as packed records
//   i32 dest | u64 tag | u32 off | u32 len                   (20 bytes)
// and coalesce per destination into FLAG_BATCH containers (byte-identical
// framing to runtime/transport.py send_buffered/flush: one entry ships
// PLAIN, containers carry the frame count in the tag's round field,
// batch_cap bounds a container).  stats_out u64[5] gets
// {frames, payload_bytes, batches, batch_frames, batch_bytes} for the
// Python-side wire.* counters.  Returns logical frames sent.
int rt_pump_flush(void *node, const uint8_t *base, const uint8_t *entries,
                  int count, int batch_cap,
                  unsigned long long *stats_out) {
  auto *nd = static_cast<Node *>(node);
  for (int i = 0; i < 5; ++i) stats_out[i] = 0;
  // dest -> accumulated `u64 tag | u32 len | payload` entries + count
  std::map<int, std::pair<std::vector<uint8_t>, int>> out;
  auto flush_one = [&](int dest, std::pair<std::vector<uint8_t>, int> &e) {
    std::vector<uint8_t> &buf = e.first;
    int cnt = e.second;
    if (cnt <= 0) return;
    if (cnt == 1) {
      uint64_t subtag;
      uint32_t ln;
      std::memcpy(&subtag, buf.data(), 8);
      std::memcpy(&ln, buf.data() + 8, 4);
      if (nd->send_msg(dest, subtag, buf.data() + 12, ln)) {
        stats_out[0] += 1;
        stats_out[1] += ln;
      }
    } else {
      uint64_t tag = (static_cast<uint64_t>(cnt) << 32) |
                     static_cast<uint64_t>(kFlagBatch);
      if (nd->send_msg(dest, tag, buf.data(),
                       static_cast<int>(buf.size()))) {
        stats_out[0] += cnt;
        stats_out[1] += buf.size() - 12ull * cnt;
        stats_out[2] += 1;
        stats_out[3] += cnt;
        stats_out[4] += buf.size();
      }
    }
    buf.clear();
    e.second = 0;
  };
  for (int i = 0; i < count; ++i) {
    const uint8_t *p = entries + static_cast<size_t>(i) * 20;
    int32_t dest;
    uint64_t tag;
    uint32_t off, len;
    std::memcpy(&dest, p, 4);
    std::memcpy(&tag, p + 4, 8);
    std::memcpy(&off, p + 12, 4);
    std::memcpy(&len, p + 16, 4);
    auto &e = out[dest];
    if (e.second > 0 &&
        e.first.size() + 12ull + len > static_cast<uint64_t>(batch_cap))
      flush_one(dest, e);
    size_t at = e.first.size();
    e.first.resize(at + 12 + len);
    std::memcpy(e.first.data() + at, &tag, 8);
    std::memcpy(e.first.data() + at + 8, &len, 4);
    std::memcpy(e.first.data() + at + 12, base + off, len);
    e.second += 1;
  }
  for (auto &kv : out) flush_one(kv.first, kv.second);
  return static_cast<int>(stats_out[0]);
}

}  // extern "C"
