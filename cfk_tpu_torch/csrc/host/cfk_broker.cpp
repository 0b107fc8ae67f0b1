// cfk_broker — the port's partitioned-log broker server.
//
// The port's own copy of the JAX package's native broker: the same wire
// protocol and the same on-disk segment format, so either package's client
// talks to either package's server and either package's FileBroker reopens
// the other's data directory.  Built by cfk_tpu_torch/_build.py with the
// host C++ compiler into cfk_tpu_torch/_build/ and spawned by
// cfk_tpu_torch/transport/tcp.py (``BrokerProcess``, the ``broker`` verb).
//
// Keep it in step with native/cfk_broker.cpp: a change to the protocol
// below or to the segment format goes into both files.
// tests/test_torch_tcp.py runs each package's client against the other's
// server and compares the two brokers' segment files byte for byte.
//
// A network service holding partitioned, offset-addressed, durable record
// logs (the role of the reference's Kafka broker): a TCP server speaking a
// small length-prefixed binary protocol, backed by the on-disk segment
// format of cfk_tpu_torch/transport/filelog.py (topic directory +
// meta.json + pNNNNN.log files of big-endian int32-key / uint32-length
// frames, torn trailing frames truncated on reopen).
//
// Concurrency: thread-per-connection, one global mutex over broker state.
// Appends and in-memory reads are O(1)/O(records) under the lock; this is a
// durable-ingest, checkpoint and serving-log endpoint, so contention is a
// non-goal.
//
// Protocol (all integers big-endian):
//   request  := u32 body_len ‖ u8 opcode ‖ payload
//   response := u32 body_len ‖ u8 status ‖ payload
//     status 0 = OK, 1 = error (payload: u16 len ‖ utf-8 message)
//   opcodes:
//     1 CREATE_TOPIC  name, u32 num_partitions            → —
//     2 PRODUCE_BATCH name, u32 n, n×{i32 partition(-1 = key mod N),
//                       i32 key, u32 value_len, value}    → u64 end_offset
//     3 FETCH         name, u32 partition, u64 start_offset,
//                       u32 max_records, u32 max_bytes    → u64 log_end,
//                       u32 n, n×{i32 key, u32 value_len, value}
//     4 NUM_PARTITIONS name                               → u32
//     5 END_OFFSET    name, u32 partition                 → u64
//     6 DELETE_TOPIC  name                                → —
//     7 PING                                              → —
//     8 LIST_TOPICS                                       → u32 n, n×name
//   name := u16 len ‖ utf-8 bytes
//
// Usage: cfk_broker PORT [DATA_DIR] [BIND_ADDR]
//   PORT 0 picks an ephemeral port.  With no DATA_DIR the logs are
//   memory-only (the InMemoryBroker behavior, reachable over TCP).
//   BIND_ADDR defaults to 127.0.0.1; pass 0.0.0.0 to accept cross-host
//   clients (DATA_DIR "" selects memory-only when a bind addr is needed).
//   Prints "CFK_BROKER LISTENING <port>" on stdout once accepting
//   connections.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cerrno>
#include <csignal>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMaxBodyLen = 64u << 20;  // 64 MiB request/response cap
constexpr int kFrameHeader = 8;              // i32 key + u32 value_len

// -- big-endian helpers ------------------------------------------------------

void put_u16(std::string& b, uint16_t v) {
  b.push_back(char(v >> 8));
  b.push_back(char(v));
}
void put_u32(std::string& b, uint32_t v) {
  for (int s = 24; s >= 0; s -= 8) b.push_back(char(v >> s));
}
void put_u64(std::string& b, uint64_t v) {
  for (int s = 56; s >= 0; s -= 8) b.push_back(char(v >> s));
}
void put_i32(std::string& b, int32_t v) { put_u32(b, uint32_t(v)); }

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  bool need(size_t n) {
    if (size_t(end - p) < n) ok = false;
    return ok;
  }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v = (uint16_t(p[0]) << 8) | p[1];
    p += 2;
    return v;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                 (uint32_t(p[2]) << 8) | p[3];
    p += 4;
    return v;
  }
  uint64_t u64() {
    uint64_t hi = u32();
    return (hi << 32) | u32();
  }
  int32_t i32() { return int32_t(u32()); }
  std::string str(size_t n) {
    if (!need(n)) return {};
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }
  std::string name() { return str(u16()); }
};

// -- log storage -------------------------------------------------------------

struct PartitionLog {
  // Byte offset of the start of each record's frame within `bytes` (memory
  // mode) or the segment file (durable mode); count = positions.size().
  std::vector<uint64_t> positions;
  std::string bytes;         // memory mode: the whole log
  FILE* file = nullptr;      // durable mode: append handle
  FILE* read_file = nullptr; // durable mode: cached fetch handle
  uint64_t file_len = 0;     // valid byte length of the segment file
};

struct Topic {
  uint32_t num_partitions = 0;
  std::vector<PartitionLog> parts;
};

struct BrokerError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

class Broker {
 public:
  explicit Broker(std::string data_dir) : data_dir_(std::move(data_dir)) {
    if (!data_dir_.empty()) recover();
  }

  void create_topic(const std::string& name, uint32_t nparts) {
    std::lock_guard<std::mutex> g(mu_);
    if (nparts < 1) throw BrokerError("num_partitions must be >= 1");
    if (topics_.count(name)) throw BrokerError("topic already exists: " + name);
    if (name.empty() || name[0] == '.' ||
        name.find('/') != std::string::npos)
      throw BrokerError("invalid topic name: " + name);
    Topic t;
    t.num_partitions = nparts;
    t.parts.resize(nparts);
    if (!data_dir_.empty()) {
      std::string dir = data_dir_ + "/" + name;
      if (::mkdir(dir.c_str(), 0777) != 0 && errno != EEXIST)
        throw BrokerError("mkdir failed: " + dir);
      write_meta(dir, nparts);
      for (uint32_t p = 0; p < nparts; ++p) open_segment(t, name, p);
    }
    topics_.emplace(name, std::move(t));
  }

  void delete_topic(const std::string& name) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = topics_.find(name);
    if (it == topics_.end()) return;
    for (auto& part : it->second.parts) {
      if (part.file) std::fclose(part.file);
      if (part.read_file) std::fclose(part.read_file);
    }
    if (!data_dir_.empty()) {
      std::string dir = data_dir_ + "/" + name;
      for (uint32_t p = 0; p < it->second.num_partitions; ++p)
        ::unlink(log_path(dir, p).c_str());
      ::unlink((dir + "/meta.json").c_str());
      ::rmdir(dir.c_str());
    }
    topics_.erase(it);
  }

  // Returns the end offset of the LAST partition appended to.
  uint64_t produce_batch(const std::string& name, Reader& r, uint32_t n) {
    std::lock_guard<std::mutex> g(mu_);
    Topic& t = find(name);
    // Validate the WHOLE batch before appending anything: a rejected
    // request must append nothing, so the client can safely re-buffer and
    // retry (all-or-nothing — never a committed prefix the producer
    // believes failed).
    {
      Reader check = r;
      for (uint32_t i = 0; i < n; ++i) {
        int32_t partition = check.i32();
        int32_t key = check.i32();
        uint32_t vlen = check.u32();
        if (!check.need(vlen)) throw BrokerError("truncated produce batch");
        check.p += vlen;
        if (partition < 0 && key < 0)
          throw BrokerError(
              "negative key requires an explicit partition (control records "
              "are routed explicitly, like the reference's EOF fan-out)");
        if (partition >= 0 && uint32_t(partition) >= t.num_partitions)
          throw BrokerError("partition out of range");
      }
    }
    // Snapshot every partition's committed extent so a mid-batch append
    // failure (disk full) can roll the whole batch back — the client treats
    // a rejected batch as not-appended and re-buffers it, so a committed
    // prefix would be served twice after a retry.
    std::vector<std::pair<size_t, uint64_t>> before(t.num_partitions);
    for (uint32_t p = 0; p < t.num_partitions; ++p) {
      PartitionLog& log = t.parts[p];
      before[p] = {log.positions.size(),
                   log.file ? log.file_len : log.bytes.size()};
    }
    uint64_t last_end = 0;
    try {
      for (uint32_t i = 0; i < n; ++i) {
        int32_t partition = r.i32();
        int32_t key = r.i32();
        uint32_t vlen = r.u32();
        const char* value = reinterpret_cast<const char*>(r.p);
        r.p += vlen;
        if (partition < 0)
          partition = int32_t(uint32_t(key) % t.num_partitions);
        PartitionLog& log = t.parts[partition];
        std::string frame;
        frame.reserve(kFrameHeader + vlen);
        put_i32(frame, key);
        put_u32(frame, vlen);
        frame.append(value, vlen);
        if (log.file) {
          if (std::fwrite(frame.data(), 1, frame.size(), log.file) !=
              frame.size())
            throw BrokerError("append failed (disk full?)");
          log.positions.push_back(log.file_len);
          log.file_len += frame.size();
        } else if (data_dir_.empty()) {
          log.positions.push_back(log.bytes.size());
          log.bytes.append(frame);
        } else {
          throw BrokerError("partition segment unavailable");
        }
        last_end = log.positions.size();
      }
    } catch (...) {
      rollback(t, name, before);
      throw;
    }
    // One flush per batch, not per record (the durability contract is the
    // same page-cache one as FileBroker(fsync=False); torn tails recover).
    // A failed flush means indexed bytes never reached the file — roll the
    // batch back and reject it rather than ack records a FETCH or restart
    // recovery would not see.
    bool flush_ok = true;
    for (auto& part : t.parts)
      if (part.file && std::fflush(part.file) != 0) flush_ok = false;
    if (!flush_ok) {
      rollback(t, name, before);
      throw BrokerError("flush failed (disk full?)");
    }
    return last_end;
  }

  void fetch(const std::string& name, uint32_t partition, uint64_t start,
             uint32_t max_records, uint32_t max_bytes, std::string& out) {
    std::lock_guard<std::mutex> g(mu_);
    Topic& t = find(name);
    if (partition >= t.num_partitions)
      throw BrokerError("partition out of range");
    PartitionLog& log = t.parts[partition];
    uint64_t end = log.positions.size();
    put_u64(out, end);
    size_t count_at = out.size();
    put_u32(out, 0);  // patched below
    uint32_t n = 0;
    if (log.file) std::fflush(log.file);
    // Reads go through a cached per-partition descriptor (opened once, kept
    // until topic deletion) — no fopen/fclose per FETCH under the lock.
    if (log.file && !log.read_file) {
      log.read_file = std::fopen(
          log_path(data_dir_ + "/" + name, partition).c_str(), "rb");
      if (!log.read_file) throw BrokerError("cannot open segment for read");
    }
    FILE* rf = log.read_file;
    for (uint64_t off = start; off < end; ++off, ++n) {
      if (n >= max_records) break;
      uint64_t pos = log.positions[off];
      uint64_t frame_end =
          (off + 1 < end) ? log.positions[off + 1]
                          : (log.file ? log.file_len : log.bytes.size());
      uint64_t flen = frame_end - pos;
      if (n > 0 && out.size() + flen > max_bytes) break;
      if (log.file) {
        size_t prev = out.size();
        out.resize(prev + flen);
        if (std::fseek(rf, long(pos), SEEK_SET) != 0 ||
            std::fread(&out[prev], 1, flen, rf) != flen)
          throw BrokerError("segment read failed");
      } else {
        out.append(log.bytes, pos, flen);
      }
    }
    out[count_at + 0] = char(n >> 24);
    out[count_at + 1] = char(n >> 16);
    out[count_at + 2] = char(n >> 8);
    out[count_at + 3] = char(n);
  }

  uint32_t num_partitions(const std::string& name) {
    std::lock_guard<std::mutex> g(mu_);
    return find(name).num_partitions;
  }

  uint64_t end_offset(const std::string& name, uint32_t partition) {
    std::lock_guard<std::mutex> g(mu_);
    Topic& t = find(name);
    if (partition >= t.num_partitions)
      throw BrokerError("partition out of range");
    return t.parts[partition].positions.size();
  }

  std::vector<std::string> list_topics() {
    std::lock_guard<std::mutex> g(mu_);
    std::vector<std::string> names;
    for (auto& kv : topics_) names.push_back(kv.first);
    return names;
  }

 private:
  Topic& find(const std::string& name) {
    auto it = topics_.find(name);
    if (it == topics_.end())
      throw BrokerError("unknown topic: " + name + " (create_topic first)");
    return it->second;
  }

  static std::string log_path(const std::string& dir, uint32_t p) {
    char buf[16];
    std::snprintf(buf, sizeof buf, "p%05u.log", p);
    return dir + "/" + buf;
  }

  static void write_meta(const std::string& dir, uint32_t nparts) {
    // Matches filelog.py's meta.json ({"num_partitions": N}); written via a
    // temp file + rename like FileBroker.create_topic.
    std::string tmp = dir + "/meta.json.tmp";
    FILE* f = std::fopen(tmp.c_str(), "w");
    if (!f) throw BrokerError("cannot write meta: " + tmp);
    std::fprintf(f, "{\"num_partitions\": %u}", nparts);
    std::fflush(f);
    ::fsync(::fileno(f));
    std::fclose(f);
    if (::rename(tmp.c_str(), (dir + "/meta.json").c_str()) != 0)
      throw BrokerError("meta rename failed");
  }

  void open_segment(Topic& t, const std::string& name, uint32_t p) {
    std::string path = log_path(data_dir_ + "/" + name, p);
    PartitionLog& log = t.parts[p];
    log.file = std::fopen(path.c_str(), "ab");
    if (!log.file) throw BrokerError("cannot open segment: " + path);
  }

  // Restore every partition of `t` to its pre-batch extent after a failed
  // produce.  Durable partitions close + truncate + reopen the segment so
  // bytes stranded in the stdio buffer by a short fwrite are discarded with
  // the torn tail instead of landing after later appends; a partition whose
  // segment cannot be reopened keeps file == nullptr, which the append path
  // rejects loudly (never silently falling back to the memory log).
  void rollback(Topic& t, const std::string& name,
                const std::vector<std::pair<size_t, uint64_t>>& before) {
    for (uint32_t p = 0; p < t.num_partitions; ++p) {
      PartitionLog& log = t.parts[p];
      // Leave partitions the batch never touched alone — no reason to risk
      // a close/reopen on a healthy segment.
      uint64_t extent = log.file ? log.file_len : log.bytes.size();
      if (log.positions.size() == before[p].first &&
          extent == before[p].second)
        continue;
      log.positions.resize(before[p].first);
      if (log.file) {
        std::fclose(log.file);
        log.file = nullptr;
        std::string path = log_path(data_dir_ + "/" + name, p);
        ::truncate(path.c_str(), off_t(before[p].second));
        log.file_len = before[p].second;
        log.file = std::fopen(path.c_str(), "ab");
      } else if (data_dir_.empty()) {
        log.bytes.resize(before[p].second);
      }
    }
  }

  // mkdir -p: create every missing component of `path`.
  static void mkdirs(const std::string& path) {
    for (size_t i = 1; i <= path.size(); ++i) {
      if (i == path.size() || path[i] == '/') {
        std::string prefix = path.substr(0, i);
        if (::mkdir(prefix.c_str(), 0777) != 0 && errno != EEXIST)
          throw BrokerError("cannot create data dir: " + prefix);
      }
    }
  }

  // FileBroker-compatible startup recovery: scan each segment, index record
  // positions, truncate a torn trailing frame.
  void recover() {
    mkdirs(data_dir_);
    DIR* d = ::opendir(data_dir_.c_str());
    if (!d) throw BrokerError("cannot open data dir: " + data_dir_);
    while (dirent* e = ::readdir(d)) {
      std::string name = e->d_name;
      if (name == "." || name == "..") continue;
      std::string dir = data_dir_ + "/" + name;
      FILE* mf = std::fopen((dir + "/meta.json").c_str(), "r");
      if (!mf) continue;
      char meta[128] = {0};
      size_t got = std::fread(meta, 1, sizeof meta - 1, mf);
      std::fclose(mf);
      (void)got;
      uint32_t nparts = 0;
      const char* colon = std::strchr(meta, ':');
      if (!colon || std::sscanf(colon + 1, "%u", &nparts) != 1 || nparts < 1)
        continue;
      Topic t;
      t.num_partitions = nparts;
      t.parts.resize(nparts);
      for (uint32_t p = 0; p < nparts; ++p) {
        std::string path = log_path(dir, p);
        FILE* f = std::fopen(path.c_str(), "rb");
        if (f) {
          PartitionLog& log = t.parts[p];
          uint8_t hdr[kFrameHeader];
          uint64_t pos = 0;
          std::fseek(f, 0, SEEK_END);
          uint64_t size = uint64_t(std::ftell(f));
          std::fseek(f, 0, SEEK_SET);
          while (pos + kFrameHeader <= size) {
            if (std::fread(hdr, 1, kFrameHeader, f) != kFrameHeader) break;
            uint32_t vlen = (uint32_t(hdr[4]) << 24) | (uint32_t(hdr[5]) << 16) |
                            (uint32_t(hdr[6]) << 8) | hdr[7];
            if (pos + kFrameHeader + vlen > size) break;  // torn tail
            log.positions.push_back(pos);
            pos += kFrameHeader + vlen;
            std::fseek(f, long(vlen), SEEK_CUR);
          }
          std::fclose(f);
          log.file_len = pos;
          if (pos < size) ::truncate(path.c_str(), long(pos));
        }
        open_segment(t, name, p);
      }
      topics_.emplace(name, std::move(t));
    }
    ::closedir(d);
  }

  std::string data_dir_;
  std::mutex mu_;
  std::map<std::string, Topic> topics_;
};

// -- connection handling -----------------------------------------------------

bool read_exact(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t got = ::recv(fd, p, n, 0);
    if (got <= 0) return false;
    p += got;
    n -= size_t(got);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t put = ::send(fd, p, n, MSG_NOSIGNAL);
    if (put <= 0) return false;
    p += put;
    n -= size_t(put);
  }
  return true;
}

void handle_request(Broker& broker, const std::vector<uint8_t>& body,
                    std::string& resp) {
  Reader r{body.data(), body.data() + body.size()};
  uint8_t opcode = 0;
  if (r.need(1)) {
    opcode = *r.p;
    ++r.p;
  }
  resp.push_back(char(0));  // OK; rewritten on error
  try {
    switch (opcode) {
      case 1: {  // CREATE_TOPIC
        std::string name = r.name();
        uint32_t nparts = r.u32();
        if (!r.ok) throw BrokerError("malformed request");
        broker.create_topic(name, nparts);
        break;
      }
      case 2: {  // PRODUCE_BATCH
        std::string name = r.name();
        uint32_t n = r.u32();
        if (!r.ok) throw BrokerError("malformed request");
        put_u64(resp, broker.produce_batch(name, r, n));
        break;
      }
      case 3: {  // FETCH
        std::string name = r.name();
        uint32_t partition = r.u32();
        uint64_t start = r.u64();
        uint32_t max_records = r.u32();
        uint32_t max_bytes = r.u32();
        if (!r.ok) throw BrokerError("malformed request");
        broker.fetch(name, partition, start, max_records,
                     std::min(max_bytes, kMaxBodyLen - 64), resp);
        break;
      }
      case 4: {  // NUM_PARTITIONS
        std::string name = r.name();
        if (!r.ok) throw BrokerError("malformed request");
        put_u32(resp, broker.num_partitions(name));
        break;
      }
      case 5: {  // END_OFFSET
        std::string name = r.name();
        uint32_t partition = r.u32();
        if (!r.ok) throw BrokerError("malformed request");
        put_u64(resp, broker.end_offset(name, partition));
        break;
      }
      case 6: {  // DELETE_TOPIC
        std::string name = r.name();
        if (!r.ok) throw BrokerError("malformed request");
        broker.delete_topic(name);
        break;
      }
      case 7:  // PING
        break;
      case 8: {  // LIST_TOPICS
        auto names = broker.list_topics();
        put_u32(resp, uint32_t(names.size()));
        for (auto& n : names) {
          put_u16(resp, uint16_t(n.size()));
          resp.append(n);
        }
        break;
      }
      default:
        throw BrokerError("unknown opcode");
    }
  } catch (const std::exception& e) {
    resp.clear();
    resp.push_back(char(1));  // error status
    std::string msg = e.what();
    if (msg.size() > 0xffff) msg.resize(0xffff);
    put_u16(resp, uint16_t(msg.size()));
    resp.append(msg);
  }
}

void serve_connection(Broker* broker, int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  std::vector<uint8_t> body;
  for (;;) {
    uint8_t lenbuf[4];
    if (!read_exact(fd, lenbuf, 4)) break;
    uint32_t blen = (uint32_t(lenbuf[0]) << 24) | (uint32_t(lenbuf[1]) << 16) |
                    (uint32_t(lenbuf[2]) << 8) | lenbuf[3];
    if (blen == 0 || blen > kMaxBodyLen) break;
    body.resize(blen);
    if (!read_exact(fd, body.data(), blen)) break;
    std::string resp;
    handle_request(*broker, body, resp);
    uint8_t hdr[4] = {uint8_t(resp.size() >> 24), uint8_t(resp.size() >> 16),
                      uint8_t(resp.size() >> 8), uint8_t(resp.size())};
    if (!write_exact(fd, hdr, 4) ||
        !write_exact(fd, resp.data(), resp.size()))
      break;
  }
  ::close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2 || argc > 4) {
    std::fprintf(stderr, "usage: cfk_broker PORT [DATA_DIR] [BIND_ADDR]\n");
    return 2;
  }
  ::signal(SIGPIPE, SIG_IGN);
  int port = std::atoi(argv[1]);
  std::unique_ptr<Broker> broker;
  try {
    broker = std::make_unique<Broker>(argc >= 3 ? argv[2] : "");
  } catch (const std::exception& e) {
    std::fprintf(stderr, "cfk_broker: %s\n", e.what());
    return 1;
  }

  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) {
    std::perror("socket");
    return 1;
  }
  int one = 1;
  ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (argc == 4 && ::inet_pton(AF_INET, argv[3], &addr.sin_addr) != 1) {
    std::fprintf(stderr, "cfk_broker: bad bind address %s\n", argv[3]);
    return 2;
  }
  addr.sin_port = htons(uint16_t(port));
  if (::bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0) {
    std::perror("bind");
    return 1;
  }
  if (::listen(lfd, 64) != 0) {
    std::perror("listen");
    return 1;
  }
  socklen_t alen = sizeof addr;
  ::getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &alen);
  std::printf("CFK_BROKER LISTENING %d\n", int(ntohs(addr.sin_port)));
  std::fflush(stdout);

  for (;;) {
    int cfd = ::accept(lfd, nullptr, nullptr);
    if (cfd < 0) {
      if (errno == EINTR) continue;
      break;
    }
    std::thread(serve_connection, broker.get(), cfd).detach();
  }
  ::close(lfd);
  return 0;
}
