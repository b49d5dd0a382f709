// Native disk spill block store (ref RapidsDiskStore.scala:38 +
// RapidsDiskBlockManager: the reference's disk tier writes through a
// JVM-managed block manager; here a C++ slab store owns the files).
//
// Design: spill data is appended into large SLAB files (default 128 MiB)
// instead of one file per batch — far fewer inode operations and no
// per-batch open/close on the hot spill path. Freed blocks return to a
// per-slab free accounting; a slab whose bytes are fully freed is
// truncated and recycled. Every block carries a CRC32 computed at write
// and verified at read (failure detection for silent disk corruption —
// SURVEY.md aux subsystems).
//
// C API (ctypes-consumed; no pybind11 in this environment):
//   sp_open(dir, slab_bytes)            -> store*
//   sp_write(store, buf, len)           -> block id (>=0) or -1
//   sp_block_size(store, id)            -> stored payload length
//   sp_read(store, id, buf, cap)        -> bytes read, -1 bad id, -2 CRC
//   sp_free(store, id)                  -> 0/-1
//   sp_stats(store, out[4])             -> {live_blocks, live_bytes,
//                                           slab_files, file_bytes}
//   sp_close(store)
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include <sys/stat.h>
#include <unistd.h>

namespace {

uint32_t crc32(const uint8_t* data, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Block {
  int slab;
  int64_t offset;
  int64_t length;
  uint32_t crc;
};

struct Slab {
  std::string path;
  FILE* f = nullptr;
  int64_t write_pos = 0;   // append cursor
  int64_t live_bytes = 0;  // not-yet-freed payload bytes
};

struct Store {
  std::mutex mu;
  std::string dir;
  int64_t slab_bytes;
  std::vector<Slab> slabs;
  std::map<int64_t, Block> blocks;
  int64_t next_id = 0;
};

Slab* slab_for_append(Store* s, int64_t need) {
  for (auto& sl : s->slabs) {
    if (sl.f && sl.write_pos + need <= s->slab_bytes) return &sl;
    // recycle fully-freed slabs
    if (sl.f && sl.live_bytes == 0 && sl.write_pos > 0) {
      if (ftruncate(fileno(sl.f), 0) == 0) {
        sl.write_pos = 0;
        if (need <= s->slab_bytes) return &sl;
      }
    }
  }
  Slab sl;
  char name[96];
  // pid + store address in the name: stores sharing a directory (other
  // processes, or several managers in one process) never collide — the
  // old fixed names truncated each other's live data via "w+b"
  snprintf(name, sizeof(name), "/spill-slab-%d-%p-%zu.bin",
           (int)getpid(), (void*)s, s->slabs.size());
  sl.path = s->dir + name;
  sl.f = fopen(sl.path.c_str(), "w+b");
  if (!sl.f) return nullptr;
  s->slabs.push_back(sl);
  return &s->slabs.back();
}

}  // namespace

extern "C" {

void* sp_open(const char* dir, int64_t slab_bytes) {
  auto* s = new Store();
  s->dir = dir;
  s->slab_bytes = slab_bytes > 0 ? slab_bytes : (128LL << 20);
  ::mkdir(dir, 0777);  // best effort; caller pre-creates parents
  return s;
}

int64_t sp_write(void* store, const uint8_t* buf, int64_t len) {
  auto* s = static_cast<Store*>(store);
  std::lock_guard<std::mutex> g(s->mu);
  Slab* sl = slab_for_append(s, len);
  if (!sl) return -1;
  if (fseeko(sl->f, sl->write_pos, SEEK_SET) != 0) return -1;
  if ((int64_t)fwrite(buf, 1, (size_t)len, sl->f) != len) return -1;
  fflush(sl->f);
  Block b;
  b.slab = (int)(sl - s->slabs.data());
  b.offset = sl->write_pos;
  b.length = len;
  b.crc = crc32(buf, (size_t)len);
  sl->write_pos += len;
  sl->live_bytes += len;
  int64_t id = s->next_id++;
  s->blocks[id] = b;
  return id;
}

int64_t sp_block_size(void* store, int64_t id) {
  auto* s = static_cast<Store*>(store);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->blocks.find(id);
  return it == s->blocks.end() ? -1 : it->second.length;
}

int64_t sp_read(void* store, int64_t id, uint8_t* buf, int64_t cap) {
  auto* s = static_cast<Store*>(store);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->blocks.find(id);
  if (it == s->blocks.end()) return -1;
  const Block& b = it->second;
  if (cap < b.length) return -1;
  Slab& sl = s->slabs[b.slab];
  if (fseeko(sl.f, b.offset, SEEK_SET) != 0) return -1;
  if ((int64_t)fread(buf, 1, (size_t)b.length, sl.f) != b.length) return -1;
  if (crc32(buf, (size_t)b.length) != b.crc) return -2;
  return b.length;
}

int sp_free(void* store, int64_t id) {
  auto* s = static_cast<Store*>(store);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->blocks.find(id);
  if (it == s->blocks.end()) return -1;
  s->slabs[it->second.slab].live_bytes -= it->second.length;
  s->blocks.erase(it);
  return 0;
}

void sp_stats(void* store, int64_t out[4]) {
  auto* s = static_cast<Store*>(store);
  std::lock_guard<std::mutex> g(s->mu);
  int64_t live = 0;
  for (auto& kv : s->blocks) live += kv.second.length;
  int64_t fbytes = 0;
  for (auto& sl : s->slabs) fbytes += sl.write_pos;
  out[0] = (int64_t)s->blocks.size();
  out[1] = live;
  out[2] = (int64_t)s->slabs.size();
  out[3] = fbytes;
}

void sp_close(void* store) {
  auto* s = static_cast<Store*>(store);
  for (auto& sl : s->slabs) {
    if (sl.f) fclose(sl.f);
    ::unlink(sl.path.c_str());
  }
  delete s;
}

}  // extern "C"
