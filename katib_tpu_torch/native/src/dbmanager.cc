// katib-db-manager — standalone native metrics daemon.
//
// TPU-native equivalent of the reference's Go DB-manager gRPC service
// (cmd/db-manager/v1beta1/main.go:51-70): a network front-end over the
// observation-log engine so trials in *other processes/hosts* (multi-host
// slice workers, black-box subprocess trials) can report metrics centrally.
// In-process trials skip this entirely and call the store directly.
//
// Protocol (all little-endian, one frame per request/response):
//   frame    := u32 payload_len, payload
//   request  := u8 op, body
//     op=1 REPORT: str16 trial, u32 n, n * (str16 metric, f64 value,
//                  f64 timestamp, i64 step)
//     op=2 GET:    str16 trial, str16 metric ("" = all)
//     op=3 DELETE: str16 trial
//     op=4 PING
//   response := u8 status (0=ok, 1=bad request), body
//     GET ok:  u32 n, n * (str16 metric, f64 value, f64 timestamp, i64 step)
//   str16    := u16 len, bytes
//
// Thread-per-connection over one mutex-guarded store; connections are
// long-lived (the Python client keeps one socket open per process).
//
// Durability (--db <path>): the reference's daemon fronts a persisted SQL
// table (pkg/db/v1beta1/mysql/mysql.go:67, schema mysql/init.go:35) — a
// crash loses nothing.  This daemon gets the same guarantee with an
// append-only frame journal: a mutation (REPORT/DELETE) first appends its
// raw request frame to the journal and flushes, then applies to the store
// — durable-before-applied-before-acked; startup replays the journal
// through the same request handler before listening.
// One serialization format for wire and disk, zero translation code.  A
// truncated tail frame (crash mid-append) is detected and trimmed on
// replay.  Without --db the daemon is the round-2 in-RAM service.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <csignal>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "obslog.h"

namespace {

kt_store_t g_store;
std::FILE* g_journal = nullptr;  // append handle; null = in-RAM mode
std::string g_journal_path;
bool g_journal_broken = false;  // unrecoverable append failure: reject writes
std::mutex g_journal_mu;

bool read_exact(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T get() {
    T v{};
    if (p + sizeof(T) > end) {
      ok = false;
      return v;
    }
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  std::string str16() {
    uint16_t n = get<uint16_t>();
    if (!ok || p + n > end) {
      ok = false;
      return {};
    }
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }
};

struct Writer {
  std::vector<uint8_t> buf;

  template <typename T>
  void put(T v) {
    size_t at = buf.size();
    buf.resize(at + sizeof(T));
    std::memcpy(buf.data() + at, &v, sizeof(T));
  }

  void str16(const std::string& s) {
    put<uint16_t>(static_cast<uint16_t>(s.size()));
    buf.insert(buf.end(), s.begin(), s.end());
  }
};

void handle_request(const std::vector<uint8_t>& req, Writer* out) {
  Reader r{req.data(), req.data() + req.size()};
  uint8_t op = r.get<uint8_t>();
  switch (op) {
    case 1: {  // REPORT
      std::string trial = r.str16();
      uint32_t n = r.get<uint32_t>();
      std::vector<std::string> metrics;
      std::vector<double> values, ts;
      std::vector<int64_t> steps;
      for (uint32_t i = 0; i < n && r.ok; ++i) {
        metrics.push_back(r.str16());
        values.push_back(r.get<double>());
        ts.push_back(r.get<double>());
        steps.push_back(r.get<int64_t>());
      }
      if (!r.ok) break;
      std::vector<const char*> cnames;
      for (const std::string& m : metrics) cnames.push_back(m.c_str());
      kt_store_report_batch(g_store, trial.c_str(),
                            static_cast<int32_t>(n), cnames.data(),
                            values.data(), ts.data(), steps.data());
      out->put<uint8_t>(0);
      return;
    }
    case 2: {  // GET
      std::string trial = r.str16();
      std::string metric = r.str16();
      if (!r.ok) break;
      kt_query_t q = kt_store_get(g_store, trial.c_str(), metric.c_str());
      int32_t n = kt_query_len(q);
      std::vector<double> values(n), ts(n);
      std::vector<int64_t> steps(n);
      if (n > 0) {
        kt_query_values(q, values.data());
        kt_query_timestamps(q, ts.data());
        kt_query_steps(q, steps.data());
      }
      const char* blob = kt_query_names_blob(q);
      out->put<uint8_t>(0);
      out->put<uint32_t>(static_cast<uint32_t>(n));
      const char* name = blob;
      for (int32_t i = 0; i < n; ++i) {
        const char* nl = std::strchr(name, '\n');
        size_t len = nl ? static_cast<size_t>(nl - name) : std::strlen(name);
        out->str16(std::string(name, len));
        out->put<double>(values[i]);
        out->put<double>(ts[i]);
        out->put<int64_t>(steps[i]);
        name = nl ? nl + 1 : name + len;
      }
      kt_query_free(q);
      return;
    }
    case 3: {  // DELETE
      std::string trial = r.str16();
      if (!r.ok) break;
      kt_store_delete(g_store, trial.c_str());
      out->put<uint8_t>(0);
      return;
    }
    case 4:  // PING
      out->put<uint8_t>(0);
      out->put<int64_t>(kt_store_total(g_store));
      return;
    default:
      break;
  }
  out->buf.clear();
  out->put<uint8_t>(1);
}

// Appends one frame; caller holds g_journal_mu.  Returns false when the
// append could not be made durable — the caller must NOT ack the request
// (acked == journaled is the whole guarantee).  A short write (ENOSPC,
// I/O error) is rolled back by truncating to the pre-write offset so it
// can't become a corrupt tail that replay would trim LATER good frames
// behind; if even the rollback fails the journal is marked broken and all
// further mutations are rejected while reads keep serving.
bool append_journal_locked(const std::vector<uint8_t>& frame) {
  if (g_journal_broken) return false;
  long start = std::ftell(g_journal);
  uint32_t len = static_cast<uint32_t>(frame.size());
  bool ok = std::fwrite(&len, sizeof(len), 1, g_journal) == 1 &&
            std::fwrite(frame.data(), 1, frame.size(), g_journal) ==
                frame.size() &&
            // flush to the OS so a killed daemon loses nothing (page cache
            // survives process death; only power loss needs fdatasync)
            std::fflush(g_journal) == 0;
  if (ok) return true;
  std::fprintf(stderr, "journal: append failed, rolling back\n");
  if (start < 0 || std::fflush(g_journal) != 0 ||
      ::truncate(g_journal_path.c_str(), start) != 0 ||
      std::fseek(g_journal, start, SEEK_SET) != 0) {
    std::fprintf(stderr, "journal: rollback failed — rejecting writes\n");
    g_journal_broken = true;
  }
  return false;
}

// Replays mutation frames from the journal into the fresh store.  Returns
// the byte offset of the last complete frame; a truncated tail (crash
// mid-append) is trimmed so subsequent appends can't corrupt the file.
void replay_journal(const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  long valid_end = 0;
  long replayed = 0;
  if (f) {
    for (;;) {
      uint32_t len;
      if (std::fread(&len, sizeof(len), 1, f) != 1) break;
      if (len == 0 || len > (64u << 20)) break;  // corrupt header
      std::vector<uint8_t> req(len);
      if (std::fread(req.data(), 1, len, f) != len) break;
      Writer ignored;
      handle_request(req, &ignored);
      valid_end = std::ftell(f);
      ++replayed;
    }
    long file_end = 0;
    if (std::fseek(f, 0, SEEK_END) == 0) file_end = std::ftell(f);
    std::fclose(f);
    if (file_end != valid_end) {
      std::fprintf(stderr, "journal: trimming truncated tail (%ld -> %ld)\n",
                   file_end, valid_end);
      if (::truncate(path, valid_end) != 0) std::perror("truncate");
    }
  }
  g_journal_path = path;
  g_journal = std::fopen(path, "ab");
  if (!g_journal) {
    std::perror("journal open");
    std::exit(1);
  }
  std::printf("JOURNAL %ld frames, %lld points\n", replayed,
              static_cast<long long>(kt_store_total(g_store)));
}

void serve_connection(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  for (;;) {
    uint32_t len;
    if (!read_exact(fd, &len, sizeof(len))) break;
    if (len == 0 || len > (64u << 20)) break;  // 64 MiB frame cap
    std::vector<uint8_t> req(len);
    if (!read_exact(fd, req.data(), len)) break;
    Writer out;
    bool is_mutation = !req.empty() && (req[0] == 1 || req[0] == 3);
    if (g_journal && is_mutation) {
      // Journal-append and store-apply form ONE critical section, in that
      // order.  One lock: with concurrent connections, separate locks
      // could journal B's DELETE before A's REPORT while the store applied
      // them the other way — replay would then resurrect deleted points.
      // Journal FIRST: if the append fails nothing was applied, so the
      // live store never diverges from what a restart would rebuild (a
      // malformed frame that journals then no-ops replays as the same
      // no-op).  Reads bypass this lock (the store has its own mutex).
      std::lock_guard<std::mutex> lock(g_journal_mu);
      if (append_journal_locked(req)) {
        handle_request(req, &out);
      } else {
        out.put<uint8_t>(1);  // not durable -> not applied -> not acked
      }
    } else {
      handle_request(req, &out);
    }
    uint32_t olen = static_cast<uint32_t>(out.buf.size());
    if (!write_exact(fd, &olen, sizeof(olen)) ||
        !write_exact(fd, out.buf.data(), olen))
      break;
  }
  ::close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  const char* host = "127.0.0.1";
  const char* db_path = nullptr;
  int port = 0;
  for (int i = 1; i < argc - 1; ++i) {
    if (!std::strcmp(argv[i], "--port")) port = std::atoi(argv[i + 1]);
    if (!std::strcmp(argv[i], "--host")) host = argv[i + 1];
    if (!std::strcmp(argv[i], "--db")) db_path = argv[i + 1];
  }
  ::signal(SIGPIPE, SIG_IGN);
  g_store = kt_store_new();
  if (db_path) replay_journal(db_path);

  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) {
    std::perror("socket");
    return 1;
  }
  int one = 1;
  ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    std::fprintf(stderr, "bad host %s\n", host);
    return 1;
  }
  if (::bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    std::perror("bind");
    return 1;
  }
  if (::listen(lfd, 64) < 0) {
    std::perror("listen");
    return 1;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &alen);
  // the spawn helper reads this line to learn the ephemeral port
  std::printf("LISTENING %d\n", ntohs(addr.sin_port));
  std::fflush(stdout);

  for (;;) {
    int cfd = ::accept(lfd, nullptr, nullptr);
    if (cfd < 0) continue;
    std::thread(serve_connection, cfd).detach();
  }
}
